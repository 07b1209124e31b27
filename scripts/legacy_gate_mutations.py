"""Mutation check of ``chip_smoke.py`` phase 22 (c)'s gradient gate, on the
CPU.

    python3 scripts/legacy_gate_mutations.py [--points 256]

Phase 22 (c) holds the legacy stack's and PointBERT's gradients on the card
to those on the CPU through ``chip_smoke.legacy_grad_errors``. This script
builds the same fp32 modules (1 layer a stack, seed 23) and a ScanRefer
batch of 2 scenes over phase 22's synthetic tree (``--points`` a cloud), runs
the sound modules once, then runs copies with one fault each and puts the
faulty gradients through that gate against the sound ones:

* backward-only faults, the forward bit-equal: the gradient through
  PointBERT's block-0 k projection or MiniPointNet's ``conv1a`` halved;
* PointBERT's forward: the groups not centred on their FPS centers,
  MiniPointNet's max-pool over the channels instead of the group's points;
* the stack's forward: the fusion without its padding masks, its two token
  types swapped, the object locations one slot off.

For each it prints the losses' and PointBERT embeddings' relative change,
and per module how many tensors stand past ``LEGACY_GRAD_RTOL``, the worst,
and whether the gate passes. Nothing here is used by the port.
"""

import argparse
import copy
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import msr3d_tpu_torch.nn.grounding as grounding  # noqa: E402
import msr3d_tpu_torch.nn.pointbert as pointbert  # noqa: E402
from msr3d_tpu_torch.ops.pointnet2 import gather_points, group_points  # noqa: E402
from msr3d_tpu_torch.optim.losses import get_losses  # noqa: E402


def submodule(module, path):
    for part in path.split("."):
        module = module[int(part)] if part.isdigit() else getattr(module, part)
    return module


def halve_backward(module, inputs, output):
    """The output unchanged, its gradient halved."""
    return output.detach() + 0.5 * (output - output.detach())


def ungrouped_centers(self, pts):
    """GroupDivider without subtracting each group's center."""
    xyz = pts[..., :3]
    centers = gather_points(xyz, pointbert.fps(xyz, self.num_group))
    idx = pointbert.knn_point(self.group_size, xyz, centers)
    return torch.cat([group_points(xyz, idx), group_points(pts[..., 3:], idx)], dim=-1), centers


def max_over_channels(self, groups):
    """MiniPointNet with both max-pools over the wrong axis."""
    b, g, k, c = groups.shape
    h = self.conv1b(F.relu(self.bn1(self.conv1a(groups.reshape(b * g, k, c)))))
    h = torch.cat([h.amax(dim=2, keepdim=True).expand_as(h), h], dim=-1)
    h = self.conv2b(F.relu(self.bn2(self.conv2a(h))))
    return h.amax(dim=1).reshape(b, g, -1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=256, help="points a cloud")
    args = ap.parse_args()
    torch.set_num_threads(4)
    cs.LEGACY_POINTS = args.points
    with tempfile.TemporaryDirectory() as tmp:
        _, cfg = cs.legacy_tree(Path(tmp) / "legacy")
        batches, _, _ = cs.legacy_batches(cfg)
    b = cs.legacy_inputs(batches["scanrefer_train_gt"], batches["scanqa_train"]["answer_label"],
                         "cpu", rows=slice(0, 2))
    stack0, pb0 = cs.legacy_modules(torch.device("cpu"), layers=1, seed=23)

    def run(hooks=()):
        stack, pb = copy.deepcopy(stack0), copy.deepcopy(pb0)
        stack.eval()
        pb.eval()
        handles = [submodule(pb, path).register_forward_hook(h) for path, h in hooks]
        loss, losses = get_losses(cs.legacy_forward(stack, b), cs.LEGACY_LOSSES,
                                  cs.LEGACY_LOSSES)
        emb = pb(b["obj_fts"])[0]
        (loss + (emb * torch.linspace(-1, 1, emb.shape[-1])).mean()).backward()
        for h in handles:
            h.remove()
        return {k: v.item() for k, v in losses.items()}, emb.detach(), {
            name: {n: p.grad.detach().clone() for n, p in m.named_parameters()
                   if p.grad is not None}
            for name, m in (("stack", stack), ("pointbert", pb))}

    l0, e0, g0 = run()
    for m, g in g0.items():
        e = cs.legacy_grad_errors(g, g)
        print(f"sound {m}: whole {e['whole']:.6g}, {len(e['zero'])} at rounding noise "
              f"{e['zero']}: their norm at most {e['noise']:.3e} of the whole")

    def report(name, l1, e1, g1):
        loss = max(abs(l1[k] - v) / abs(v) for k, v in l0.items())
        emb = ((e1 - e0).norm() / e0.norm()).item()
        out = [f"{name}: losses {loss:.2e}, PointBERT embeddings {emb:.2e}"]
        for m in g0:
            e = cs.legacy_grad_errors(g0[m], g1[m])
            over = sum(v > cs.LEGACY_GRAD_RTOL for v in e["rel"].values())
            out.append(f"{m}: {over} of {len(e['rel'])} past {cs.LEGACY_GRAD_RTOL}, worst "
                       f"{e['max']:.3g} ({next(iter(e['worst']))}), noise {e['noise']:.2e}, "
                       f"gate {'passes' if e['ok'] else 'FAILS'}")
        print("; ".join(out))

    report("block 0's k projection: gradient halved",
           *run([("pcd_encoder.block.0.attn.k_proj", halve_backward)]))
    report("MiniPointNet's conv1a: gradient halved",
           *run([("pcd_encoder.encoder.conv1a", halve_backward)]))
    for cls, attr, fault, name in (
            (pointbert.GroupDivider, "forward", ungrouped_centers, "groups not centred"),
            (pointbert.MiniPointNet, "forward", max_over_channels,
             "MiniPointNet's max over the wrong axis")):
        sound = getattr(cls, attr)
        setattr(cls, attr, fault)
        try:
            report(name, *run())
        finally:
            setattr(cls, attr, sound)

    fusion_forward = grounding.UnifiedSpatialCrossEncoderV2.forward

    def unmasked(self, txt, txt_masks, obj, obj_locs, obj_masks, generator=None):
        return fusion_forward(self, txt, torch.ones_like(txt_masks), obj, obj_locs,
                              torch.ones_like(obj_masks), generator)

    grounding.UnifiedSpatialCrossEncoderV2.forward = unmasked
    try:
        report("the fusion without its padding mask", *run())
    finally:
        grounding.UnifiedSpatialCrossEncoderV2.forward = fusion_forward
    types = stack0["fusion"].token_type_embeddings.weight
    sound_types = types.detach().clone()
    with torch.no_grad():
        types.copy_(sound_types.flip(0))
    report("token types swapped", *run())
    with torch.no_grad():
        types.copy_(sound_types)
    locs = b["obj_locs"]
    b["obj_locs"] = locs.roll(1, dims=1)
    report("locations one slot off", *run())
    b["obj_locs"] = locs
    return 0


if __name__ == "__main__":
    sys.exit(main())
