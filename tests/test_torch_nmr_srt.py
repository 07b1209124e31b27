"""Parity of the port's multi-view reconstruction path with the JAX package:
the port's PNG reader (``msr3d_tpu_torch/data/png.py``) against Pillow,
``transform_points``, ``NMRMVRecon`` item by item (train and val,
``canonical`` on and off, ``full_scale``), the octal class id, the octave
encodings, ``RayPredictor``, ``SRTDecoder``, ``SRTEncoder``, and an NMR
batch through encoder and decoder with the mean squared error's gradients
against ``jax.grad``.

The NMR tree is ``build_nmr_tree``'s (RGBA and RGB, 6 views of 32², PNGs
with every filter type). NMR draws from Python's ``random`` and numpy's
global generator for train items, so both generators are re-seeded before
each package iterates. SRT runs at hidden 64, one transformer layer, the
conv pyramid at its default depth. The JAX side is jitted. Tolerances:
PNG pixels, dataset items and transform_points bit-equal; each octave of
the encodings within 1e-6 (fp32 sines of the same fp32 arguments);
module outputs within 1e-5 relative to their scale above 1; gradients
within 1e-4 of each tensor's norm.
"""

import functools
import io
import random
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import msr3d_tpu.nn.srt as js
from msr3d_tpu.config import config_from_dict as jax_config_from_dict
from msr3d_tpu.data.data_utils import transform_points as jax_transform_points
from msr3d_tpu.data.datasets.nmr import NMRMVRecon as JaxNMR
from msr3d_tpu_torch import registry
from msr3d_tpu_torch.config import config_from_dict
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.data import build as port_data_build  # noqa: F401 (registers NMR)
from msr3d_tpu_torch.data.data_utils import transform_points
from msr3d_tpu_torch.data.png import encode_png, read_png
from msr3d_tpu_torch.data.synthetic import build_nmr_tree, nmr_config_dict
from msr3d_tpu_torch.nn import build as port_nn_build  # noqa: F401 (registers SRT)
from msr3d_tpu_torch.nn import srt as ps

from torch_parity_utils import perturbed

ATOL, ENC_ATOL, GRAD_NORM_RTOL = 1e-5, 1e-6, 1e-4
VIEWS, SIZE, HIDDEN = 6, 32, 64


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale)


def load(module, variables):
    state, skipped = jax_to_torch_state_dict(variables)
    assert skipped == []
    module.load_state_dict(state, strict=True)
    return module.eval()


def pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def filter_types(data: bytes):
    """The filter byte of each row of an 8-bit RGB(A) PNG."""
    pos, idat = 8, b""
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if ctype == b"IHDR":
            width, height, _, colour = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        if ctype == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = width * (4 if colour == 6 else 3) + 1
    return {raw[y * stride] for y in range(height)}


def picture(seed, channels, h=48, w=45):
    """Gradients plus noise, on which Pillow's adaptive choice takes several
    filters."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 4, yy * 4, (xx + yy) * 2, 255 - xx * 2][:channels], -1)
    return np.clip(img + r.integers(0, 20, img.shape), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# PNG


@pytest.mark.parametrize("channels", [3, 4])
def test_png_reader_equals_pillow(channels):
    """Bit-equal to Pillow on the files Pillow writes (its adaptive filters,
    and with ``optimize``, which adds Average) and on the port's encoder's,
    each filter type forced, one file split over many IDAT chunks."""
    img = picture(channels, channels)
    seen = set()
    for opts in ({}, {"optimize": True}):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG", **opts)
        data = buf.getvalue()
        seen |= filter_types(data)
        np.testing.assert_array_equal(read_png(data), pillow(data))
    assert len(seen) >= 3
    for kind in range(5):
        data = encode_png(img, (kind,))
        assert filter_types(data) == {kind}
        np.testing.assert_array_equal(read_png(data), pillow(data))
        np.testing.assert_array_equal(read_png(data), img)
    data = encode_png(img, idat_size=64)
    assert data.count(b"IDAT") > 5
    np.testing.assert_array_equal(read_png(data), pillow(data))


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    img = picture(0, 3)
    data = bytearray(encode_png(img))
    bad = bytes(data[:-5]) + bytes([data[-5] ^ 1]) + bytes(data[-4:])  # IEND's CRC
    with pytest.raises(ValueError, match="CRC"):
        read_png(bad)
    ihdr = bytearray(data[16:29])
    ihdr[12] = 1  # Adam7
    adam7 = bytes(data[:16]) + bytes(ihdr) + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr)) \
        + bytes(data[33:])
    with pytest.raises(ValueError, match="Adam7"):
        read_png(adam7)
    for name, pil in (("palette", Image.fromarray(img).convert("P")),
                      ("grey", Image.fromarray(img[..., 0])),
                      ("grey16", Image.fromarray(img[..., 0].astype(np.uint16) * 200))):
        path = tmp_path / f"{name}.png"
        pil.save(path)
        with pytest.raises(ValueError, match="colour type"):
            read_png(path)
    with pytest.raises(ValueError):
        read_png(bytes(data[:60]))  # truncated


def test_transform_points_equals_jax():
    r = np.random.default_rng(1)
    for dtype in (np.float32, np.float64):
        pts = r.normal(size=(5, 7, 3)).astype(dtype)
        mat = r.normal(size=(4, 4)).astype(dtype)
        for translate in (True, False):
            got = transform_points(pts, mat, translate)
            want = jax_transform_points(pts, mat, translate)
            assert got.dtype == want.dtype == dtype
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(transform_points(pts, mat[:3].astype(np.float32)),
                                  jax_transform_points(pts, mat[:3].astype(np.float32)))


# ---------------------------------------------------------------------------
# NMR


@pytest.fixture(scope="module")
def nmr_trees(tmp_path_factory):
    """RGBA and RGB trees: 2 classes x 2 scenes x VIEWS views of SIZE²."""
    return {rgba: build_nmr_tree(tmp_path_factory.mktemp(f"nmr_{rgba}"),
                                 np.random.default_rng(7 if rgba else 8), n_classes=2,
                                 scenes_per_class=2, n_views=VIEWS, size=SIZE, rgba=rgba)
            for rgba in (True, False)}


def items(cls, cfg, split, seed=0):
    random.seed(seed)
    np.random.seed(seed)
    ds = cls(cfg, split)
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("rgba,canonical,full_scale", [
    (True, True, False), (True, False, False), (False, True, True)])
def test_nmr_items_equal_jax(nmr_trees, rgba, canonical, full_scale):
    """Every item of train and val bit-equal to JAX's, draws included."""
    cfg = nmr_config_dict(nmr_trees[rgba], points_per_item=50, n_views=VIEWS,
                          canonical=canonical, full_scale=full_scale)
    port_cls = registry.DATASET_REGISTRY.get("NMRMVRecon")
    for split in ("train", "val"):
        got = items(port_cls, config_from_dict(cfg), split)
        want = items(JaxNMR, jax_config_from_dict(cfg), split)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])
                assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype
        n = 50 if not full_scale else (VIEWS - 1) * SIZE * SIZE
        assert got[0]["target_rays"].shape == (n, 3)
        assert got[0]["input_images"].shape == (1, SIZE, SIZE, 3)


def test_octal_class_id_raises_in_both(tmp_path):
    """YAML 1.1 reads an unquoted ``04256520`` as the octal integer 1138000:
    joining it into a path raises TypeError in both packages."""
    (tmp_path / "metadata.yaml").write_text("04256520:\n  id: 04256520\n  name: sofa\n")
    cfg = nmr_config_dict(tmp_path, n_views=VIEWS)
    for cls, make in ((registry.DATASET_REGISTRY.get("NMRMVRecon"), config_from_dict),
                      (JaxNMR, jax_config_from_dict)):
        with pytest.raises(TypeError):
            cls(make(cfg), "train")


# ---------------------------------------------------------------------------
# SRT


@pytest.mark.parametrize("octaves,start", [(15, 0), (8, 0), (4, 3)])
def test_encodings_per_octave(octaves, start):
    """Each octave's sines and cosines within ENC_ATOL of JAX's, on
    coordinates of camera scale (up to about 3): the top octave's fp32
    arguments reach 1e5."""
    r = np.random.default_rng(octaves + start)
    coords = (r.normal(size=(2, 64, 3)) * 1.5).astype(np.float32)
    got = ps.positional_encoding(torch.from_numpy(coords), octaves, start).numpy()
    want = np.asarray(js.positional_encoding(jnp.asarray(coords), octaves, start))
    err = np.abs(got - want).reshape(2, 64, 2, 3, octaves).max(axis=(0, 1, 2, 3))
    assert (err <= ENC_ATOL).all(), err
    rays = r.normal(size=(2, 64, 3)).astype(np.float32)
    close(ps.ray_encoding(*map(torch.from_numpy, (coords, rays)), pos_start_octave=start),
          js.ray_encoding(jnp.asarray(coords), jnp.asarray(rays), pos_start_octave=start),
          ENC_ATOL)
    image_rays = r.normal(size=(2, 5, 6, 3)).astype(np.float32)
    close(ps.ray_image_encoding(torch.from_numpy(coords[:, 0]), torch.from_numpy(image_rays),
                                pos_start_octave=start),
          js.ray_image_encoding(jnp.asarray(coords[:, 0]), jnp.asarray(image_rays),
                                pos_start_octave=start), ENC_ATOL)


def srt_inputs(seed, b=2, views=2, n=40):
    r = np.random.default_rng(seed)
    return dict(
        images=r.uniform(size=(b, views, SIZE, SIZE, 3)).astype(np.float32),
        cam=(r.normal(size=(b, views, 3)) * 1.5).astype(np.float32),
        rays=r.normal(size=(b, views, SIZE, SIZE, 3)).astype(np.float32),
        pts=(r.normal(size=(b, n, 3)) * 1.5).astype(np.float32),
        dirs=r.normal(size=(b, n, 3)).astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def srt_modules():
    """The JAX encoder and decoder with perturbed variables."""
    x = srt_inputs(0)
    jenc = js.SRTEncoder(num_att_blocks=1, hidden_dim=HIDDEN, num_heads=4, mlp_dim=128)
    venc = perturbed(jax.jit(jenc.init)(jax.random.key(0), x["images"], x["cam"], x["rays"]),
                     1, 0.02)
    z = jax.jit(jenc.apply)(venc, x["images"], x["cam"], x["rays"])
    jdec = js.SRTDecoder(hidden_dim=HIDDEN)
    vdec = perturbed(jax.jit(jdec.init)(jax.random.key(1), z, x["pts"], x["dirs"]), 2, 0.02)
    return jenc, venc, jdec, vdec


def port_modules():
    jenc, venc, jdec, vdec = srt_modules()
    tenc = load(registry.VISION_REGISTRY.get("SRTEncoder")(
        num_att_blocks=1, hidden_dim=HIDDEN, num_heads=4, mlp_dim=128), venc)
    tdec = load(registry.HEADS_REGISTRY.get("SRTDecoder")(hidden_dim=HIDDEN), vdec)
    return tenc, tdec


def test_ray_predictor_matches_jax():
    x = srt_inputs(3)
    z = np.random.default_rng(4).normal(size=(2, 8, HIDDEN)).astype(np.float32)
    jmod = js.RayPredictor(num_att_blocks=2, pos_start_octave=1, z_dim=HIDDEN, input_mlp=True,
                           output_mlp=True)
    v = perturbed(jax.jit(jmod.init)(jax.random.key(2), z, x["pts"], x["dirs"]), 3, 0.02)
    tmod = load(ps.RayPredictor(num_att_blocks=2, pos_start_octave=1, z_dim=HIDDEN,
                                input_mlp=True, output_mlp=True), v)
    got = tmod(*map(torch.from_numpy, (z, x["pts"], x["dirs"])))
    assert got.shape == (2, 40, 3)
    close(got, jax.jit(jmod.apply)(v, z, x["pts"], x["dirs"]))


def test_srt_encoder_and_decoder_match_jax():
    jenc, venc, jdec, vdec = srt_modules()
    tenc, tdec = port_modules()
    x = srt_inputs(5)
    want_z = jax.jit(jenc.apply)(venc, x["images"], x["cam"], x["rays"])
    got_z = tenc(*map(torch.from_numpy, (x["images"], x["cam"], x["rays"])))
    assert got_z.shape == (2, 2 * 4, HIDDEN)  # 32² → 2² patches a view
    close(got_z, want_z)
    want = jax.jit(jdec.apply)(vdec, want_z, x["pts"], x["dirs"])
    got = tdec(torch.from_numpy(np.array(want_z)), *map(torch.from_numpy,
                                                         (x["pts"], x["dirs"])))
    close(got, want)
    assert ((got > 0) & (got < 1)).all()


def test_nmr_batch_through_srt_gradients_match_jax(nmr_trees):
    """Two NMR train items (RGBA, canonical) → encoder → decoder → mean
    squared error to the target pixels, the reference's SRT objective:
    the loss and every parameter's gradient against ``jax.grad``."""
    cfg = nmr_config_dict(nmr_trees[True], points_per_item=40, n_views=VIEWS)
    batch = items(registry.DATASET_REGISTRY.get("NMRMVRecon"), config_from_dict(cfg),
                  "train", seed=3)[:2]
    stack = {k: np.stack([it[k] for it in batch]) for k in
             ("input_images", "input_camera_pos", "input_rays", "target_images",
              "target_camera_pos", "target_rays")}
    jenc, venc, jdec, vdec = srt_modules()

    def loss_fn(ve, vd):
        z = jenc.apply(ve, stack["input_images"], stack["input_camera_pos"],
                       stack["input_rays"])
        pix = jdec.apply(vd, z, stack["target_camera_pos"], stack["target_rays"])
        return jnp.mean((pix - stack["target_images"]) ** 2)

    want_loss, (g_enc, g_dec) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(venc, vdec)
    tenc, tdec = port_modules()
    t = {k: torch.from_numpy(v) for k, v in stack.items()}
    z = tenc(t["input_images"], t["input_camera_pos"], t["input_rays"])
    pix = tdec(z, t["target_camera_pos"], t["target_rays"])
    loss = ((pix - t["target_images"]) ** 2).mean()
    close(loss, want_loss)
    loss.backward()
    for module, grads in ((tenc, g_enc), (tdec, g_dec)):
        want, _ = jax_to_torch_state_dict(grads)
        named = dict(module.named_parameters())
        assert sorted(want) == sorted(named)
        largest = max(np.linalg.norm(w.numpy()) for w in want.values())
        for name, p in named.items():
            w = want[name].numpy()
            err = np.linalg.norm(p.grad.numpy() - w)
            # a key projection's bias moves every logit of a query alike, which
            # the softmax takes out: its gradient is 0 in exact arithmetic, and
            # what fp32 leaves is held to the module's largest gradient
            ref = largest if name.endswith("k_proj.bias") else np.linalg.norm(w)
            assert err <= GRAD_NORM_RTOL * ref, (name, err)


def test_registry_names():
    assert registry.VISION_REGISTRY.get("SRTEncoder") is ps.SRTEncoder
    assert registry.HEADS_REGISTRY.get("SRTDecoder") is ps.SRTDecoder
    assert registry.DATASET_REGISTRY.get("NMRMVRecon").__module__.endswith("datasets.nmr")
