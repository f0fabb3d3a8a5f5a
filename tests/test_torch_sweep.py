"""The shared reverse sweep's plain version: lane groups, the shading-only
instance, the colour-only cotangent and the layout the wrappers check.

``csrc/sweep.cuh`` lets ``LANES`` neighbouring threads share one set of
sums, each slot taking lane 0's terms, then lane 1's (in one pass, each slot
added by the lane that owns it), keeps the geometry sums in double, and has
an instance without the geometry chain for a colour-only cotangent without
NEE. ``sweep._sweep_plain`` follows that order, so on the CPU
these tests hold

- the shading-only instance to the full one: the same shading sums bit for
  bit, exact zeros in the geometry and camera entries;
- a colour-only cotangent [3, h, W] to [10, h, W] with seven planes of
  zeros, in every configuration, and K4 on NEE diffuse to K3's replay;
- lane-group accumulation to one set of sums a pixel: within 1e-6 of the
  largest of the kind (measured 7.7e-8: float32 shading sums added in
  another order; the geometry sums are double either way), at odd widths
  and for blocks whose thread count ``LANES`` does not divide;
- the dispatch (``ad_grad_kernel.instance``, ``pack_cotangents``, the
  inverse step's ``cross_grads``) to the shading-only instance exactly when
  there is no NEE and no AOV cotangent;
- the shading-only gradients through ``ad_loss_and_grads`` to jnp
  reverse-mode AD of the JAX package at a block of 3 x 3 threads
  (emission and albedo: rtol 2e-3 plus 5e-4 of the largest, the tolerance
  of tests/test_torch_ad_grad.py);
- ``n_slots``, ``shared_bytes`` and the wrappers' shared-memory check;
- ``lane_pair_shares`` (how often a pair's two lanes add to one slot) on a
  hand-made path tape, and the bounce loop that
  ``scripts/torch_sweep_occupancy.py`` finds in a hand-made SASS listing;
- the import graph of ``ops/``, which points one way (``trace_kernel`` <-
  ``sweep`` <- the two sweep wrappers <- ``grad_kernel``), and
  ``grad_kernel``'s one replay entry against the direct calls of K3's and
  K4's plain replay it replaced: the same bits.

The kernels against this plain version on the card are in
tests/test_torch_nee_grad_cuda.py and tests/test_torch_ad_grad_cuda.py.
"""

import ast
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtrace_tpu import Camera as JaxCamera
from pathtrace_tpu import RenderConfig as JaxConfig
from pathtrace_tpu import cornell_box as jax_cornell_box
from pathtrace_tpu.grad import l2_image_loss, render_color

from pathtrace_tpu_torch import Camera, RenderConfig, cornell_box
from pathtrace_tpu_torch.convert import grads_to_numpy
from pathtrace_tpu_torch.ops import ad_grad_kernel as ak
from pathtrace_tpu_torch.ops import grad_kernel as gk
from pathtrace_tpu_torch.ops import nee_grad_kernel as nk
from pathtrace_tpu_torch.ops import sweep
from pathtrace_tpu_torch.ops import trace_kernel as tk

CONFIGS = {"diffuse": {}, "nee": {"nee": True}, "glossy": {"brdf": "glossy"},
           "nee_glossy": {"nee": True, "brdf": "glossy"}}
N = 9


def cfg_of(name, width=24, height=10, spp=2, **kw):
    return RenderConfig(width=width, height=height, spp=spp, max_bounces=3, seed=3,
                        backend="cuda", **{**CONFIGS[name], **kw})


def launch_args(cfg, frame=1):
    return (cornell_box().packed(), tk.camera_block(Camera.create(), cfg),
            tk.make_seed_block(cfg, frame), cfg)


def cotangent(cfg, channels=10, seed=0):
    ct = np.random.default_rng(seed).normal(size=(channels, cfg.height, cfg.width))
    if channels == 10:
        ct[9] *= 1e-4  # depth is ~1e4 in these units
    return torch.from_numpy(ct.astype(np.float32))


def geometry_entries(sums):
    block = sweep.block_from_sums(sums)
    return torch.cat([block[:N, :4].reshape(-1), block[N:, :3].reshape(-1)])


@pytest.mark.parametrize("name", ["diffuse", "glossy"])
@pytest.mark.parametrize("block", [8, 3])
def test_shading_only_instance_equals_the_full_one(name, block):
    cfg = cfg_of(name, block=block)
    kw = dict(local_h=cfg.height, spp=cfg.spp)
    ct = cotangent(cfg)
    ct[3:] = 0.0
    full = ak.replay(*launch_args(cfg), ct, **kw)
    only = ak.replay(*launch_args(cfg), ct[:3].contiguous(), **kw)
    assert torch.equal(only, full)
    assert full.abs().max() > 0
    assert not geometry_entries(only).any() and not geometry_entries(full).any()
    # the plain sweep of the shading-only instance keeps no geometry sums at all
    lat = tk.PlainLattice(*launch_args(cfg)[:3], cfg, cfg.height)
    shade, geom = sweep._sweep_plain(lat, cfg, cfg.spp, list(ct[:3]))
    assert geom is None and len(shade) == 6 * N


@pytest.mark.parametrize("name", list(CONFIGS))
def test_colour_only_cotangent_equals_zero_aov_planes(name):
    cfg = cfg_of(name)
    kw = dict(local_h=cfg.height, spp=cfg.spp)
    ct = cotangent(cfg)
    ct[3:] = 0.0
    ten = ak.replay(*launch_args(cfg), ct, **kw)
    three = ak.replay(*launch_args(cfg), ct[:3].contiguous(), **kw)
    assert torch.equal(three, ten)
    assert bool(geometry_entries(three).any()) == cfg.nee
    if name == "nee":  # the NEE kernel's replay is this instance
        k3 = nk.replay(*launch_args(cfg), ct[:3].permute(1, 2, 0).contiguous(), **kw)
        assert torch.equal(three, k3)


@pytest.mark.parametrize("name,block,width,height", [
    ("nee", 8, 24, 10), ("nee", 3, 13, 7), ("nee_glossy", 5, 13, 7), ("glossy", 3, 13, 7),
    ("diffuse", 1, 9, 4), ("nee", 16, 24, 10)])
def test_lane_groups_against_one_set_of_sums_a_pixel(name, block, width, height):
    """``LANES`` threads adding into one set of sums in turns give the sums
    of one set a thread, up to the order of the float32 shading adds."""
    cfg = cfg_of(name, width=width, height=height, block=block)
    sb, cb, seed, _ = launch_args(cfg)
    lat = tk.PlainLattice(sb, cb, seed, cfg, height)
    planes = list(cotangent(cfg))
    aov = None if name in ("glossy", "diffuse") else planes[3:]
    zero = torch.zeros(height, width)
    out = {}
    for lanes in (sweep.LANES, 1):
        shade, geom = sweep._sweep_plain(lat, cfg, cfg.spp, planes[:3], aov, lanes=lanes)
        assert shade[0].shape[1] == -(-block * block // lanes)
        out[lanes] = sweep._flat_sums(N, shade, geom, zero)
    checks, err = sweep.agreement(out[sweep.LANES], out[1], "sums")
    assert all(ok for *_, ok in checks), checks
    assert out[1].abs().max() > 0


@pytest.mark.parametrize("block,width,height", [(8, 24, 10), (3, 13, 7), (5, 4, 4), (1, 3, 2)])
def test_lane_groups_cover_every_pixel_once(block, width, height):
    groups = sweep.LaneGroups(height, width, block, "cpu")
    n_blocks = -(-height // block) * -(-width // block)
    assert groups.index.shape == (n_blocks, -(-block * block // sweep.LANES), sweep.LANES)
    inside = groups.index[groups.index < height * width]
    assert torch.equal(inside.sort().values, torch.arange(height * width))
    # thread tid of a block: lane tid % LANES of group tid // LANES
    pixels = torch.arange(height * width, dtype=torch.float32).reshape(height, width)
    lanes = groups.split(pixels, -1.0)
    for tid in range(min(block * block, 6)):
        ty, tx = divmod(tid, block)
        want = float(ty * width + tx) if ty < height and tx < width else -1.0
        assert float(lanes[tid % sweep.LANES][0, tid // sweep.LANES]) == want
    if (block * block) % sweep.LANES:  # the last thread is alone in its group
        assert bool((lanes[-1][:, -1] == -1.0).all())


def test_lane_pair_shares_read_the_flags_words():
    """A hand-made path tape of 3 bounces and 5 threads (two lane pairs and
    a block's lone last thread, which has no pair): a lane counts below the
    hit count that the last bounce's flags word carries, whatever its dead
    bounces' words hold; the flags' other bits are masked off."""
    hits = torch.tensor([3, 3, 1, 0, 2], dtype=torch.int32)
    flags = torch.tensor([[2 | 16, 2 | 32, 8, 8, 1],     # one winner; the light; a dead 8
                          [3, 8 | 48, 8, 4, 1],          # the light in lane 1; pair 2 dead
                          [5, 6, 7, 7, 7]], dtype=torch.int32)  # two winners
    flags[2] = torch.where(hits > 2, flags[2], 0) | hits << sweep.HIT_SHIFT
    words = torch.zeros(1, 1, 3, sweep.TAPE_WORDS["diffuse"], 5)
    words[0, 0, :, 0] = flags.view(torch.float32)
    got = sweep.lane_pair_shares(words, 8)
    assert got["pairs"].tolist() == [2, 1, 1]
    assert got["same"].tolist() == [0.5, 0.0, 0.0]
    assert got["light"].tolist() == [0.5, 1.0, 0.0]
    assert got["either"].tolist() == [1.0, 1.0, 0.0]
    # two samples of it count each pair's bounce twice: the same shares
    twice = sweep.lane_pair_shares(torch.cat([words, words]), 8)
    assert twice["pairs"].tolist() == [4, 2, 2] and twice["either"].tolist() == [1.0, 1.0, 0.0]


SASS = """
        Function : _ZN4anon15nee_grad_kernelILi2ELb1EEEvN2pt11TraceParamsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDGSTS.E [R2], desc[UR4][R4.64] ;
        /*0020*/                   LDS R3, [R2] ;
        /*0030*/                   LDGSTS.E [R2], desc[UR4][R4.64] ;
        /*0040*/                   SHFL.BFLY PT, R5, R5, 0x1, 0x1f ;
        /*0050*/                   STS [R2], R3 ;
        /*0060*/              @P0 BRA 0x30 ;
        /*0070*/                   DADD R6, R6, R8 ;
        /*0080*/              @P1 BRA P2, 0x20 ;
        /*0090*/                   LDS R7, [R9] ;
        /*00a0*/              @P3 BRA 0x90 ;
        /*00b0*/                   EXIT ;
        Function : _ZN4anon14ad_grad_kernelILb1ELb1ELb0ELb1ELb0EEEvN2pt11TraceParamsE
        /*0000*/                   EXIT ;
"""


def test_occupancy_script_finds_the_bounce_loop():
    """``scripts/torch_sweep_occupancy.py`` counts over the innermost loop
    (a branch back, predicated or not, to its target) that holds the ring's
    ``LDGSTS``, in the taped instances alone, on a hand-made listing."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_sweep_occupancy.py"
    spec = importlib.util.spec_from_file_location("torch_sweep_occupancy", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    listing = script.sass_listing(SASS)
    assert [len(v) for v in listing.values()] == [12, 1]
    assert script.bounce_loop(list(listing.values())[0]) == [
        "LDGSTS.E [R2], desc[UR4][R4.64]", "SHFL.BFLY PT, R5, R5, 0x1, 0x1f", "STS [R2], R3",
        "@P0 BRA 0x30"]
    assert script.loop_counts(listing) == {"K3 replay taped": dict(
        LDS=0, STS=1, DADD=0, SHFL=1, WARPSYNC=0, BSYNC=0, instructions=4)}


def test_slots_and_shared_bytes_of_the_layout():
    assert sweep.LANES == 2
    assert sweep.n_slots(9) == 156 and sweep.n_slots(9, geom=False) == 54
    assert sweep.n_slots(11) == 184 and sweep.n_slots(16) == 254
    # 64 threads in 32 lane pairs: the sums, a loss float a thread, 9 sphere rows
    assert sweep.shared_bytes(9, 8) == 4 * (156 * 32 + 64 + 90) == 20584
    assert sweep.shared_bytes(9, 8, geom=False) == 4 * (54 * 32 + 64 + 90) == 7528
    # an odd block: 9 threads in 5 groups
    assert sweep.shared_bytes(9, 3) == 4 * (156 * 5 + 9 + 90)
    # the largest block at the all-parameter backward's 11 spheres, and at 16
    assert sweep.shared_bytes(11, 16) == 95672 <= sweep.MAX_SHARED_BYTES == 232448
    assert sweep.shared_bytes(16, 16) == 131712 <= sweep.MAX_SHARED_BYTES


@pytest.mark.parametrize("kernel", ["nee", "ad"])
def test_wrappers_check_the_new_layout_against_shared_memory(kernel):
    """A 16 x 16 block at 11 spheres fits 232,448 bytes and runs, and so does
    the largest launch either wrapper accepts: what they refuse (a sphere or
    a block edge more) they refuse before any launch, so none can exceed a
    block's shared memory."""
    cfg = cfg_of("nee" if kernel == "nee" else "glossy", width=8, height=8, spp=1, block=16)
    sb = torch.cat([cornell_box().packed(), cornell_box().packed()[:2]])
    cb, seed = tk.camera_block(Camera.create(), cfg), tk.make_seed_block(cfg)
    kw = dict(local_h=8, spp=1)

    def run(sb, cfg):
        if kernel == "nee":
            return nk.replay(sb, cb, seed, cfg, torch.zeros(8, 8, 3), **kw)
        return ak.replay(sb, cb, seed, cfg, torch.zeros(10, 8, 8), **kw)

    assert run(sb, cfg).shape == (126,)
    most = tk.MAX_SPHERES if kernel == "nee" else ak.MAX_SPHERES
    assert sweep.shared_bytes(most, tk.MAX_BLOCK) <= sweep.MAX_SHARED_BYTES == 232448
    with pytest.raises(ValueError, match="spheres"):
        run(torch.cat([sb] * 2)[: most + 1].contiguous(), cfg)
    with pytest.raises(ValueError, match="block edge"):
        run(sb, dataclasses.replace(cfg, block=tk.MAX_BLOCK + 1))


@pytest.mark.parametrize("brdf", ["diffuse", "glossy"])
@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("channels", [3, 10])
def test_dispatch_picks_the_shading_only_instance(brdf, nee, channels):
    cfg = RenderConfig(width=8, height=4, spp=1, brdf=brdf, nee=nee)
    inst = ak.instance(cfg, channels)
    assert inst == dict(glossy=brdf == "glossy", nee=nee, aov=channels == 10,
                        geom=nee or channels == 10)
    assert (not inst["geom"]) == (not nee and channels == 3)
    with pytest.raises(ValueError, match="channels"):
        ak.instance(cfg, 7)


def test_pack_cotangents_builds_no_zero_planes():
    cfg = RenderConfig(width=6, height=4, spp=2)
    c = torch.rand(4, 6, 3)
    only = ak.pack_cotangents(cfg, c)
    assert only.shape == (3, 4, 6) and only.is_contiguous()
    full = ak.pack_cotangents(cfg, c, ct_depth=torch.zeros(4, 6))
    assert full.shape == (10, 4, 6) and torch.equal(full[:3], only) and not full[3:].any()
    assert ak.pack_cotangents(cfg).shape == (3, 4, 6) and not ak.pack_cotangents(cfg).any()
    assert ak.pack_cotangents(cfg, c, local_h=2, spp=1).shape == (3, 4, 6)


@pytest.mark.parametrize("name", ["glossy", "nee_glossy"])
def test_inverse_step_gradients_pass_a_colour_only_cotangent(name, monkeypatch):
    """``cross_grads``, the inverse step's gradient, hands K4 three planes:
    without NEE that is the shading-only instance."""
    cfg = cfg_of(name, width=8, height=4)
    seen = []
    replay = ak.replay

    def spy(sb, cb, seed, cfg_, ct, **kw):
        seen.append(ak.instance(cfg_, ct.shape[0]))
        return replay(sb, cb, seed, cfg_, ct, **kw)

    monkeypatch.setattr(ak, "replay", spy)
    loss, d = gk.cross_grads(cornell_box(), Camera.create(), cfg, 0, torch.rand(4, 8, 3),
                             device="cpu")
    assert len(seen) == 2 and all(not i["aov"] for i in seen)
    assert all(i["geom"] == cfg.nee for i in seen)
    assert torch.isfinite(loss) and d["color"].abs().max() > 0
    assert bool(d["position"].any()) == cfg.nee


def test_shading_only_gradients_match_jnp_ad():
    """Diffuse without NEE through ``ad_loss_and_grads`` (a colour-only
    cotangent: the shading-only instance) at a 3 x 3 block, whose last
    thread has no lane partner, against jnp reverse-mode AD."""
    base = dict(width=32, height=8, spp=2, max_bounces=3, seed=3)
    jcfg = JaxConfig(backend="jnp", **base)
    cfg = RenderConfig(backend="cuda", block=3, **base)
    target = np.random.default_rng(0).uniform(size=(8, 32, 3)).astype(np.float32)
    jscene, jcam = jax_cornell_box(), JaxCamera.create()

    def loss_fn(scene_):
        return l2_image_loss(render_color(scene_, jcam, jcfg, 0), jnp.asarray(target))

    loss_j, ds_j = jax.value_and_grad(loss_fn)(jscene)
    loss, (ds, dc) = ak.ad_loss_and_grads(cornell_box(), Camera.create(), cfg, 0,
                                          torch.from_numpy(target), device="cpu")
    got = grads_to_numpy(ds, dc)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    for field in ("emission", "color"):
        want = np.asarray(getattr(ds_j, field))
        np.testing.assert_allclose(got[field], want, rtol=2e-3,
                                   atol=5e-4 * float(np.abs(want).max()), err_msg=field)
        assert np.abs(got[field]).max() > 0
    assert not got["position"].any() and not got["radius"].any()
    assert not got["cam_position"].any() and not np.asarray(ds_j.position).any()


def test_block_edge_does_not_change_the_sums_beyond_rounding():
    """The lane groups follow the block edge; the sums do not, up to the
    order of the adds (1e-6 of the largest of a kind)."""
    cfg8 = cfg_of("nee", width=16, height=8)
    cfg5 = dataclasses.replace(cfg8, block=5)
    ct = cotangent(cfg8, 3).permute(1, 2, 0).contiguous()
    kw = dict(local_h=8, spp=cfg8.spp)
    checks, _ = sweep.agreement(nk.replay(*launch_args(cfg5), ct, **kw),
                             nk.replay(*launch_args(cfg8), ct, **kw), "sums")
    assert all(ok for *_, ok in checks), checks


def _ops_imports(tree):
    """(the ``ops`` modules a module imports at its top level, those it
    imports inside a function body)."""
    top, inner = set(), set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(node):
            inner |= _ops_names(sub)
    for node in tree.body:
        top |= _ops_names(node)
    return top, inner


def _ops_names(node):
    if isinstance(node, ast.ImportFrom) and node.module == "pathtrace_tpu_torch.ops":
        return {a.name for a in node.names}
    if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
            "pathtrace_tpu_torch.ops."):
        return {node.module.rsplit(".", 1)[1]}
    if isinstance(node, ast.Import):
        return {a.name.rsplit(".", 1)[1] for a in node.names
                if a.name.startswith("pathtrace_tpu_torch.ops.")}
    return set()


def test_ops_import_graph_points_one_way():
    """No module under ``ops/`` imports an ``ops`` module inside a function
    body; the two sweep wrappers import neither each other nor
    ``grad_kernel``, and ``sweep`` none of the three (parsed, not
    imported)."""
    ops = Path(sweep.__file__).parent
    top = {}
    for path in sorted(ops.glob("*.py")):
        top[path.stem], inner = _ops_imports(ast.parse(path.read_text()))
        assert not inner, f"{path.name} imports {sorted(inner)} inside a function"
    wrappers = {"nee_grad_kernel", "ad_grad_kernel", "grad_kernel"}
    assert not top["nee_grad_kernel"] & wrappers and not top["ad_grad_kernel"] & wrappers
    assert not top["sweep"] & (wrappers | {"sweep"})
    assert {"sweep", "trace_kernel"} <= top["nee_grad_kernel"] & top["ad_grad_kernel"]
    assert {"nee_grad_kernel", "ad_grad_kernel", "sweep"} <= top["grad_kernel"]


@pytest.mark.parametrize("name", ["nee", "nee_glossy"])
def test_one_replay_entry_is_the_kernels_own_replay(name):
    """``grad_kernel._replay_sums`` against the cotangent of the mean colour
    gives the bits of the direct calls it replaced: K3's replay with 1/spp
    folded in by the caller, ``residual / denom / spp``; K4's on
    ``pack_cotangents(cfg, residual / denom)``."""
    cfg = cfg_of(name, width=8, height=8, spp=2)
    sb, cb, seed, _ = launch_args(cfg, frame=3)
    residual = cotangent(cfg, channels=3, seed=4).permute(1, 2, 0).contiguous()
    denom = cfg.height * cfg.width * 3
    kw = dict(local_h=8, spp=2, device=torch.device("cpu"))
    got = gk._replay_sums(sb, cb, seed, cfg, residual / denom, **kw)
    if name == "nee":
        want = nk.replay_plain(sb, cb, seed, cfg, residual / denom / cfg.spp, **kw)
    else:
        want = ak.replay_plain(sb, cb, seed, cfg, ak.pack_cotangents(cfg, residual / denom,
                                                                     **kw), **kw)
    assert torch.equal(got, want) and got.abs().max() > 0
