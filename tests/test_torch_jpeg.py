"""The port's object-crop path against Pillow and the JAX package.

The oracle is Pillow over libjpeg-turbo (the JAX package reads crops with
``Image.open(p).convert("RGB")`` and resizes them with ``Image.BILINEAR``):

* ``decode_jpeg`` (``csrc/jpeg_decode.cc``) is bit-equal to Pillow's decode
  over a matrix of chroma subsampling (4:4:4, 4:2:2, 4:2:0, grayscale) x
  encoding (quality 50, 75, 95, optimized Huffman tables, restart markers) x
  size (1x1 to 640x480, widths whose chroma is 2 pixels or less included);
  a 4:4:0 frame, progressive, CMYK and truncated files raise ``ValueError``;
* ``resize_bilinear`` is bit-equal to Pillow's ``BILINEAR`` resize (up,
  down, one axis kept, non-square, and a hypothesis search over sizes up to
  700), and ``preprocess_2d`` is float32 bit-equal to JAX's;
* the committed fixture crops' manifest holds Pillow's and JAX's digests of
  the committed files (``tests/test_torch_kernels.py`` holds the port to
  the same manifest without Pillow or JAX, so it runs on the GPU host too).

Rewrite the fixture crops and their manifest, on a host with Pillow:

    PYTHONPATH=. python tests/test_torch_jpeg.py
"""

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, features

from msr3d_tpu.data.data_utils import preprocess_2d as jax_preprocess_2d
from msr3d_tpu_torch.data import jpeg, native
from msr3d_tpu_torch.data.data_utils import preprocess_2d, resize_bilinear
from msr3d_tpu_torch.data.jpeg import decode_jpeg

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "msr3d_tpu_torch" / "data" / "fixtures" / "crops"

# (file stem, (width, height), Pillow's save options, grayscale)
FIXTURE_SPECS = (
    ("chair_444_q95_97x61", (97, 61), dict(quality=95, subsampling=0), False),
    ("table_422_q75_33x17", (33, 17), dict(quality=75, subsampling=1), False),
    ("lamp_420_q75_640x480", (640, 480), dict(quality=75, subsampling=2), False),
    ("sofa_420_optimize_224x224", (224, 224), dict(quality=75, subsampling=2, optimize=True),
     False),
    ("wall_420_restart_150x100", (150, 100),
     dict(quality=95, subsampling=2, restart_marker_blocks=3), False),
    ("door_gray_q75_45x80", (45, 80), dict(quality=75), True),
    ("cup_422_q50_300x200", (300, 200), dict(quality=50, subsampling=1, optimize=True), False),
    ("box_420_q95_1x1", (1, 1), dict(quality=95, subsampling=2), False),
)
PREPROCESS_SIZES = ((224, 224), (32, 32))


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def crop_like(rng, width: int, height: int) -> np.ndarray:
    """(H, W, 3) uint8: smooth colour gradients, a sinusoidal texture and
    noise, the statistics of an object crop more than of white noise."""
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    u, v = x / max(width - 1, 1), y / max(height - 1, 1)
    phase = rng.uniform(0, 2 * np.pi, 3)
    freq = rng.uniform(4, 24, 3)
    img = np.stack([
        255 * (0.2 + 0.6 * u) + 30 * np.sin(freq[0] * u + phase[0]),
        255 * (0.7 - 0.5 * v) + 30 * np.sin(freq[1] * (u + v) + phase[1]),
        255 * (0.3 + 0.4 * u * v) + 30 * np.sin(freq[2] * v + phase[2]),
    ], axis=-1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def encode(img: np.ndarray, gray: bool = False, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if gray else img).save(buf, "JPEG", **options)
    return buf.getvalue()


def pillow_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def manifest_entry(path: Path) -> dict:
    """Pillow's decode of ``path`` and JAX's ``preprocess_2d`` of it."""
    img = pillow_decode(path.read_bytes())
    entry = {"file": path.name, "shape": list(img.shape), "decoded_sha256": _sha(img)}
    for w, h in PREPROCESS_SIZES:
        entry[f"preprocess_{w}x{h}_sha256"] = _sha(jax_preprocess_2d(img, size=(w, h)))
    return entry


def write_fixtures(out_dir: Path = FIXTURES, seed: int = 16) -> dict:
    """Write the fixture crops (Pillow's encoder, seeded images) and
    ``manifest.json`` with the digests ``manifest_entry`` gives."""
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    entries = []
    for stem, (w, h), options, gray in FIXTURE_SPECS:
        path = out_dir / f"{stem}.jpg"
        path.write_bytes(encode(crop_like(rng, w, h), gray, **options))
        entries.append(manifest_entry(path))
    manifest = {
        "written_by": "tests/test_torch_jpeg.py (write_fixtures)",
        "pillow": Image.__version__, "libjpeg_turbo": features.version("libjpeg_turbo"),
        "crops": entries}
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


def test_pillow_here_is_built_on_libjpeg_turbo():
    """The decoder reproduces libjpeg-turbo's arithmetic; another libjpeg
    (IJG 9's IDCT and upsampling differ) would make this oracle wrong."""
    assert features.check_feature("libjpeg_turbo"), features.version("jpg")
    assert features.version("libjpeg_turbo").split(".")[0] == "3"


SUBSAMPLINGS = {"444": dict(subsampling=0), "422": dict(subsampling=1),
                "420": dict(subsampling=2), "gray": {}}
ENCODINGS = {
    "q50": dict(quality=50), "q75": dict(quality=75), "q95": dict(quality=95),
    "q75-optimize": dict(quality=75, optimize=True),
    "q75-restart": dict(quality=75, restart_marker_blocks=2),
    "q95-optimize-restart": dict(quality=95, optimize=True, restart_marker_blocks=5),
}
# (width, height); width 3 leaves 4:2:x chroma 2 pixels wide, where
# libjpeg-turbo replicates instead of its fancy upsampling
SIZES = ((1, 1), (3, 5), (7, 5), (33, 17), (97, 61), (224, 224), (640, 480))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
@pytest.mark.parametrize("sub", sorted(SUBSAMPLINGS))
def test_decode_bit_equal_to_pillow(sub, encoding, size):
    rng = np.random.default_rng([len(sub), len(encoding), *size])
    data = encode(crop_like(rng, *size), sub == "gray", **SUBSAMPLINGS[sub], **ENCODINGS[encoding])
    want = pillow_decode(data)
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape == (size[1], size[0], 3)
    assert np.array_equal(got, want)


def test_build_raises_with_the_compilers_log_and_never_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "bad.cc"
    bad.write_text("int f() { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*undeclared_name"):
        native.build_library(bad, "libbad")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        native.build_library(jpeg.SRC, "libmsr3d_jpeg")
    monkeypatch.setattr(jpeg, "_lib", None)
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        decode_jpeg(encode(crop_like(np.random.default_rng(1), 8, 8)))


def test_decode_reads_a_path_and_names_it_in_errors(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "crop.jpg"
    path.write_bytes(encode(crop_like(rng, 20, 12), quality=80))
    assert np.array_equal(decode_jpeg(path), pillow_decode(path.read_bytes()))
    assert np.array_equal(decode_jpeg(str(path)), decode_jpeg(path.read_bytes()))
    path.write_bytes(path.read_bytes()[:200])
    with pytest.raises(ValueError, match="crop.jpg: .*truncated"):
        decode_jpeg(path)


def _refused_files():
    rng = np.random.default_rng(3)
    img = crop_like(rng, 61, 45)
    full = encode(img, quality=90)
    yield "progressive", encode(img, quality=90, progressive=True), "progressive"
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG", quality=90)
    yield "cmyk", cmyk.getvalue(), "4-component"
    yield "truncated-scan", full[: len(full) // 2], "truncated"
    yield "truncated-no-eoi", full[:-2], "truncated"
    yield "truncated-header", full[:100], "truncated"
    # 4:4:0: the luma sampling byte of a 4:4:4 frame set to h 1, v 2
    h440 = bytearray(encode(img, quality=90, subsampling=0))
    sof = h440.index(b"\xff\xc0")
    assert h440[sof + 11] == 0x11
    h440[sof + 11] = 0x12
    yield "440", bytes(h440), "subsampling 1x2"


@pytest.mark.parametrize("name,data,reason", list(_refused_files()),
                         ids=[c[0] for c in _refused_files()])
def test_decode_refuses_what_it_does_not_handle(name, data, reason):
    with pytest.raises(ValueError, match=reason):
        decode_jpeg(data)
    if name.startswith("truncated"):
        with pytest.raises(OSError):  # Pillow refuses them too
            pillow_decode(data)


RESIZES = {
    # name: ((in width, in height), (out width, out height))
    "up-square-224": ((33, 17), (224, 224)),
    "down-224": ((640, 480), (224, 224)),
    "down-32": ((97, 61), (32, 32)),
    "up-32": ((7, 5), (32, 32)),
    "width-kept": ((224, 300), (224, 224)),
    "height-kept": ((300, 224), (224, 224)),
    "both-kept": ((224, 224), (224, 224)),
    "non-square": ((150, 100), (224, 96)),
    "one-pixel": ((1, 1), (224, 224)),
    "to-one-pixel": ((97, 61), (1, 1)),
}


def _pillow_resize(img: np.ndarray, size) -> np.ndarray:
    return np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))


@pytest.mark.parametrize("case", sorted(RESIZES))
def test_resize_bit_equal_to_pillow(case):
    (w, h), size = RESIZES[case]
    img = crop_like(np.random.default_rng(w * 1000 + h), w, h)
    assert np.array_equal(resize_bilinear(img, size), _pillow_resize(img, size))


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.integers(1, 700), st.integers(1, 700), st.integers(1, 700), st.integers(1, 700),
       st.integers(0, 2**32 - 1))
def test_resize_bit_equal_to_pillow_at_random_sizes(w, h, ow, oh, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    assert np.array_equal(resize_bilinear(img, (ow, oh)), _pillow_resize(img, (ow, oh)))


@pytest.mark.parametrize("size", [(224, 224), (32, 32), (224, 96)], ids=str)
@pytest.mark.parametrize("shape", [(480, 640), (61, 97), (17, 33), (224, 224)], ids=str)
def test_preprocess_2d_bit_equal_to_jax(shape, size):
    img = crop_like(np.random.default_rng(shape[0]), shape[1], shape[0])
    got, want = preprocess_2d(img, size=size), jax_preprocess_2d(img, size=size)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fixture_manifest_holds_pillow_and_jax_digests():
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    files = sorted(p.name for p in FIXTURES.glob("*.jpg"))
    assert files == sorted(e["file"] for e in manifest["crops"]) and len(files) == len(FIXTURE_SPECS)
    assert sum((FIXTURES / f).stat().st_size for f in files) < 200_000
    for entry in manifest["crops"]:
        assert manifest_entry(FIXTURES / entry["file"]) == entry
    subsamplings = {spec[2].get("subsampling", "gray") for spec in FIXTURE_SPECS}
    assert subsamplings == {0, 1, 2, "gray"}
    assert any(w * h > 224 * 224 for _, (w, h), _, _ in FIXTURE_SPECS)


if __name__ == "__main__":
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURES
    written = write_fixtures(out)
    print(f"{len(written['crops'])} crops and manifest.json written to {out}")
