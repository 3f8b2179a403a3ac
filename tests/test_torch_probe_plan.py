"""K8's launch plan (``experiments.dw_dot_probe.plan``), on the CPU.

The plan is the launch ``csrc/dot_probe.cu`` takes: per output tile of 32
rows of p by tn rows of g, a cluster of CTAs that split K. These tests hold
it to what the kernel needs, at the six probes, chip_smoke.py's PROBE_EDGES
and the card tests' PROBE_CASES (both read from their files, so a new edge
there is checked here too), in bf16 and f32.
"""

import ast
import re
from pathlib import Path

import pytest
import torch

from vae_cyclegan_tpu_torch.experiments import dw_dot_probe

ROOT = Path(__file__).resolve().parents[1]


def _literal(path: Path, name: str):
    """The literal value assigned to `name` at the top of `path`."""
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return ast.literal_eval(node.value)
    raise KeyError(f"{name} in {path}")


PROBES = [(mk, nk, kk) for _, mk, nk, kk, _ in dw_dot_probe.SHAPES]
EDGES = [c[:3] for c in _literal(ROOT / "chip_smoke.py", "PROBE_EDGES")
         + _literal(ROOT / "tests" / "test_torch_kernels.py", "PROBE_CASES")]
CASES = sorted(set(PROBES + EDGES))
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plan_slices_cover_kk(case, dtype):
    """The ranks' K slices: multiples of 16, disjoint, covering [0, kk) in
    rank order, none empty (small kk shrinks the cluster)."""
    mk, nk, kk = case
    pl = dw_dot_probe.plan(mk, nk, kk, dtype)
    assert pl.kslice % 16 == 0
    slices = pl.slices(kk)
    assert len(slices) == pl.cluster
    assert slices[0][0] == 0 and slices[-1][1] == kk
    for (lo, hi), (nxt, _) in zip(slices, slices[1:] + [(kk, kk)]):
        assert lo % 16 == 0 and lo < hi and hi == nxt


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plan_fits_the_kernel(case, dtype):
    """A tile width and cluster size the kernel has (C <= 16), every rank
    owning quads of the tile, the grid the tiles times the cluster, and the
    shared bytes of csrc/dot_probe.cu's layout within the 227 KB a CTA can
    have."""
    mk, nk, kk = case
    pl = dw_dot_probe.plan(mk, nk, kk, dtype)
    assert pl.tn in dw_dot_probe.TILE_NS
    assert pl.cluster in dw_dot_probe.CLUSTERS and pl.cluster <= 16
    quads = dw_dot_probe.TILE_M * pl.tn // 4
    assert (pl.cluster - 1) * dw_dot_probe.share(pl.tn, pl.cluster) < quads
    assert pl.tiles == -(-mk // 32) * -(-nk // pl.tn)
    assert pl.ctas == pl.tiles * pl.cluster
    assert pl.smem == dw_dot_probe.smem_bytes(pl.tn, pl.kslice, dtype,
                                              pl.cluster)
    assert pl.smem <= 227 * 1024


@pytest.mark.parametrize("probe", dw_dot_probe.SHAPES, ids=lambda s: s[0])
def test_probes_fill_the_card(probe):
    """bf16, the probes' own type: the four tail and head probes' CTAs fit
    the 132 SMs in one wave. The two u4 probes hold 288 CTAs of ~100 KB,
    more than 132 SMs take at two a SM, so they take two: no plan with a
    cluster of a power of two fits them in one (PERF.md, §6)."""
    name, mk, nk, kk, _ = probe
    pl = dw_dot_probe.plan(mk, nk, kk, torch.bfloat16)
    want = 2 if name.startswith("u4") else 1
    assert dw_dot_probe.waves(pl) == want == min(
        dw_dot_probe.waves(c)
        for c in dw_dot_probe.candidates(mk, nk, kk, torch.bfloat16))
    assert pl.ctas <= want * dw_dot_probe.SMS * dw_dot_probe.CTAS_PER_SM


def test_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="no launch holds"):
        dw_dot_probe.plan(32, 32, 16 * 227 * 1024, torch.float32)


def test_plan_mirrors_the_kernel_constants():
    """dw_dot_probe's geometry constants are csrc/dot_probe.cu's."""
    src = (ROOT / "vae_cyclegan_tpu_torch" / "csrc" / "dot_probe.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kTileM") == dw_dot_probe.TILE_M
    assert const("kWarps") == dw_dot_probe.WARPS
    assert const("kPad") == dw_dot_probe.PART_PAD
    assert const("kMaxCluster") == max(dw_dot_probe.CLUSTERS)
    assert const("kWarpN") * 4 == max(dw_dot_probe.TILE_NS)
