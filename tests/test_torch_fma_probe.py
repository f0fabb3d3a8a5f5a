"""scripts/torch_fma_probe.py against scripts/fma_probe.py on the CPU.

The chain: the port's ``chain_run`` (eagerly, and with its trip through
``torch.compile``, Inductor's C++ here) against the JAX script's run,
built from its ``_chain_body`` and ``lax.fori_loop`` as ``xla_chain_rate``
builds it (fma_probe.py:71-83), on the same numpy inputs. Tolerance:
``mul`` and ``add`` to the bit; ``fma`` rtol 1e-5 of each element
(measured 2.84e-6 at most, on 776 of 1,024 elements, since XLA's CPU
backend rounds ``x*a+b`` once and torch twice, at each of 24 steps). There
b = 1e-7 x lies under one ulp of x, so the roundings decide every step and
a dropped ``+b`` hides inside rtol 1e-5: one trip (``make_trip``, eager and
compiled) is also held against ``_chain_body`` with b of order 1e-2, at
the same tolerances, where a step or an op missing fails even at rtol
1e-5 (the test shows that it does). The derived fields against the TPU's
record (docs/fma_probe_r5.json), ``main`` on the CPU with K6 and K7 at tiny
depths, the flags against the JAX script's, and the exit without a card.
The card's own run is chip_smoke.py phase 24.
"""

import functools
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from pathtrace_tpu_torch.ops import build
from pathtrace_tpu_torch.utils import roofline as rf

REPO = Path(__file__).resolve().parents[1]
TPU_RECORD = REPO / "docs" / "fma_probe_r5.json"
ITERS, INNER, CHAINS, SHAPE = 3, 8, 2, (8, 128)
RTOL = {"mul": 0.0, "add": 0.0, "fma": 1e-5}


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def port():
    return load_script("torch_fma_probe")


@pytest.fixture(scope="module")
def jax_script():
    return load_script("fma_probe")


def inputs():
    rng = np.random.default_rng(0)
    x = (1.0 + 0.1 * rng.uniform(size=SHAPE)).astype(np.float32)
    a = (0.9999 + 1e-4 * rng.uniform(size=SHAPE)).astype(np.float32)
    return x, a


def jax_run(jax_script, mode, x, a):
    """fma_probe.py:71-83, the run that ``xla_chain_rate`` jits."""
    chain = jax_script._chain_body(INNER, mode)

    def run(x, a):
        b = x * jnp.float32(1e-7)
        init = tuple(x * (1.0 + 0.001 * c) for c in range(CHAINS))

        def body(_, xs):
            return tuple(chain(xc, a, b) for xc in xs)

        final = lax.fori_loop(0, ITERS, body, init)
        acc = final[0]
        for xc in final[1:]:
            acc = acc + xc
        return acc

    return np.asarray(jax.jit(run)(jnp.asarray(x), jnp.asarray(a)))


@pytest.mark.parametrize("route", ["eager", "compiled"])
@pytest.mark.parametrize("mode", ["mul", "add", "fma"])
def test_chain_run_matches_jax(port, jax_script, mode, route):
    x, a = inputs()
    trip = None
    if route == "compiled":
        trip = torch.compile(port.make_trip(mode, INNER), fullgraph=True, dynamic=False)
    got = port.chain_run(torch.from_numpy(x), torch.from_numpy(a), mode, iters=ITERS,
                         inner=INNER, chains=CHAINS, trip=trip)
    want = jax_run(jax_script, mode, x, a)
    assert got.dtype == torch.float32 and got.shape == SHAPE
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[mode], atol=0)


def trip_inputs():
    """x and a of ``inputs``, and b of order 1e-2: every op of a trip moves it."""
    x, a = inputs()
    b = (0.01 + 0.01 * np.random.default_rng(1).uniform(size=SHAPE)).astype(np.float32)
    return x, a, b


def port_trip(trip, x, a, b):
    """One chain through the port's trip, which stacks its chains last."""
    t = [torch.from_numpy(v).unsqueeze(-1) for v in (x, a, b)]
    return trip(*t)[..., 0].numpy()


@pytest.mark.parametrize("route", ["eager", "compiled"])
@pytest.mark.parametrize("mode", ["mul", "add", "fma"])
def test_trip_matches_jax_chain_body(port, jax_script, mode, route):
    """One trip of ``INNER`` steps against ``_chain_body(INNER, mode)`` with
    b of order 1e-2, at ``RTOL``. Measured: ``mul`` and ``add`` to the bit,
    ``fma`` 8.67e-7 at most, on 759 of 1,024 elements (one rounding in XLA,
    two in torch). Even rtol 1e-5 fails a trip one step short (by 1.0e-4
    for ``mul``, 1.7e-2 for the others) and, for ``fma``, a trip without its
    add (1.4e-1) or its multiply (7.7e-4)."""
    x, a, b = trip_inputs()
    trip = port.make_trip(mode, INNER)
    if route == "compiled":
        trip = torch.compile(trip, fullgraph=True, dynamic=False)
    want = np.asarray(jax.jit(jax_script._chain_body(INNER, mode))(*map(jnp.asarray, (x, a, b))))
    got = port_trip(trip, x, a, b)
    np.testing.assert_allclose(got, want, rtol=RTOL[mode], atol=0)
    wrong = [port.make_trip(mode, INNER - 1)]
    if mode == "fma":
        wrong += [port.make_trip("mul", INNER), port.make_trip("add", INNER)]
    for w in wrong:
        assert not np.allclose(port_trip(w, x, a, b), want, rtol=RTOL["fma"], atol=0)


@pytest.mark.parametrize("mode", ["mul", "add", "fma"])
def test_trip_error_finds_a_wrong_trip(port, mode):
    """``trip_error``, the script's check of each compiled trip: a right trip
    lies within ``TRIP_RTOL``, one a step short or with an op missing
    does not, even at ``fma``'s."""
    kw = dict(inner=INNER, chains=CHAINS, shape=SHAPE, device="cpu")
    assert port.trip_error(port.make_trip(mode, INNER), mode, **kw) == 0.0
    wrong = [port.make_trip(mode, INNER - 1)]
    if mode == "fma":
        wrong += [port.make_trip("mul", INNER), port.make_trip("add", INNER)]
    for w in wrong:
        assert port.trip_error(w, mode, **kw) > port.TRIP_RTOL["fma"]


def test_chain_modes_are_the_jax_scripts(port):
    x, a = (torch.from_numpy(v) for v in inputs())
    b = x * np.float32(1e-7)
    for mode, want in (("mul", x * a), ("add", x + b), ("fma", x * a + b)):
        assert torch.equal(port.chain_step(x, a, b, mode), want)
    with pytest.raises(ValueError):
        port.make_trip("fma_fma", INNER)


def test_derived_reproduces_the_tpu_record(port):
    """The four derived fields of the TPU's record from its latencies,
    ``fma_single_slot: false`` included: the same arithmetic, the same bits."""
    rec = json.loads(TPU_RECORD.read_text())
    got = port.derived(rec["latency_ns_per_step"])
    assert got == {k: rec[k] for k in got}
    assert got["fma_single_slot"] is False
    one_op = dict(rec["latency_ns_per_step"], fma=rec["latency_ns_per_step"]["mul"])
    assert port.derived(one_op)["fma_single_slot"] is True


def test_main_on_cpu_writes_every_key_of_the_tpu_record(port, monkeypatch, tmp_path, capsys):
    """``main`` on the CPU with K6 and K7 at tiny depths and the compiled leg
    at (8, 128): the record holds every key of docs/fma_probe_r5.json, the
    compiled trip is one kernel with one store (the chains side by side),
    and the private compile caches are not left in the environment."""
    monkeypatch.setattr(rf, "measure_f32_peak",
                        functools.partial(rf.measure_f32_peak, iters=1, grid=1, reps=1))
    monkeypatch.setattr(rf, "latency_probe",
                        functools.partial(rf.latency_probe, iters=1, grid=1, reps=1))
    monkeypatch.setattr(port, "SHAPE", SHAPE)
    out = tmp_path / "rec.json"
    assert port.main(["--device", "cpu", "--iters", "2", "--inner", "4", "--chains", "2",
                      "--json", str(out)]) == 0
    for k in ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):  # the private caches are gone
        assert "torch_fma_probe_" not in os.environ.get(k, "")
    rec = json.loads(out.read_text())
    want = json.loads(TPU_RECORD.read_text())
    assert set(want) <= set(rec)
    assert set(want["latency_ns_per_step"]) == set(rec["latency_ns_per_step"])
    assert rec["backend"] == "cpu" and rec["device"] == "cpu" and rec["shape"] == list(SHAPE)
    assert (rec["iters"], rec["inner"], rec["chains"]) == (2, 4, 2)
    rates = [rec[f"xla_{m}_ops_per_s"] for m in ("mul", "add", "fma")]
    rates += [rec["pallas_mul_ops_per_s"], rec["pallas_fma_flops_per_s"],
              *rec["latency_ns_per_step"].values()]
    assert all(np.isfinite(v) and v > 0 for v in rates)
    assert {m: (t["kernels"], t["stores"]) for m, t in rec["compiled_trip"].items()} == \
        {m: (1, 1) for m in ("mul", "add", "fma")}
    assert all(t["max_rel_err"] <= t["rtol"] == port.TRIP_RTOL[m]
               for m, t in rec["compiled_trip"].items())
    assert rec["kernel_launches"] == {"peak": 0, "latency": 0}  # the plain versions ran
    assert "wrote" in capsys.readouterr().out


def flags(help_text):
    return set(re.findall(r"(?<![\w-])--[a-z][a-z-]*", help_text))


def test_flags_are_the_jax_scripts_and_device(port):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "fma_probe.py"), "--help"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    jax_flags = flags(proc.stdout)
    assert {"--json", "--iters", "--inner", "--chains"} <= jax_flags
    assert flags(port.build_parser().format_help()) == jax_flags | {"--device"}
    args = port.build_parser().parse_args([])
    assert (args.iters, args.inner, args.chains, args.json, args.device) == (64, 256, 8, None,
                                                                             None)


def test_without_a_card_it_exits_nonzero(port, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert port.main([]) != 0
    assert "device" in capsys.readouterr().err
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "torch_fma_probe.py")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_sass_counts_read_the_opcodes(port, monkeypatch):
    """What the card's record counts, on a listing in ``cuobjdump -sass``'s
    form: the opcode of each instruction, predicated or not, suffixes aside,
    through ``build.sass_functions`` and ``build.sass_counts``, which the two
    occupancy scripts also read their listings with."""
    listing = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : triton_poi_fused_add_mul_0",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */",
        "                                                              /* 0x000fe20000000800 */",
        "        /*0010*/                   FFMA R3, R2, R4, R5 ;      /* 0x000000040203723 */",
        "        /*0020*/              @!P0 FFMA R3, R3, R4, R5 ;      /* 0x000000040303723 */",
        "        /*0030*/                   FMUL.FTZ R6, R3, R4 ;      /* 0x000000040306720 */",
        "        /*0040*/                   STG.E.128 desc[UR4][R2.64], R4 ;  "
        "/* 0x0000000402007986 */",
        "\t\tFunction : other",
        "        /*0000*/                   FADD R1, R2, R3 ;          /* 0x0000000302017221 */",
    ])
    monkeypatch.setattr(build.subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
        a, 0, stdout=listing, stderr=""))
    monkeypatch.setattr(build.shutil, "which", lambda name: "/bin/cuobjdump")
    functions = build.sass_functions("k.cubin")
    assert functions["other"] == ["FADD R1, R2, R3"]
    assert functions["triton_poi_fused_add_mul_0"][2] == "@!P0 FFMA R3, R3, R4, R5"
    assert build.sass_counts(functions, port.SASS_RE) == {
        "triton_poi_fused_add_mul_0": {"FFMA": 2, "FMUL": 1, "FADD": 0, "STG": 1,
                                       "instructions": 5},
        "other": {"FFMA": 0, "FMUL": 0, "FADD": 1, "STG": 0, "instructions": 1}}
