"""The port's inventory: every module, script and TPU kernel of the JAX
package has its counterpart in the port.

- Every ``.py`` of ``pathtrace_tpu/`` has a file of the same path under
  ``pathtrace_tpu_torch/``; the four Pallas modules ``ops/pallas_*.py``
  became ``ops/*_kernel.py`` plus a CUDA source (``PALLAS_MODULES``).
- Every script under ``scripts/`` that is not the port's own
  (``torch_*``) has a ``torch_`` counterpart (``SCRIPTS`` where the names
  differ), or is one of the two plotting scripts, which import neither JAX
  nor the JAX package and read the port's files as they are.
- Every ``pl.pallas_call(`` site in ``pathtrace_tpu/`` and ``scripts/`` is
  in ``PALLAS_CALLS``, mapped to the CUDA source under
  ``pathtrace_tpu_torch/csrc/`` that replaces it, which exists and names
  the TPU file in its text. A new site fails here until it is ported.
"""

import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG, CSRC = REPO / "pathtrace_tpu", REPO / "pathtrace_tpu_torch", \
    REPO / "pathtrace_tpu_torch" / "csrc"

PALLAS_MODULES = {
    "ops/pallas_trace.py": "ops/trace_kernel.py",
    "ops/pallas_grad.py": "ops/grad_kernel.py",
    "ops/pallas_nee_grad.py": "ops/nee_grad_kernel.py",
    "ops/pallas_ad.py": "ops/ad_grad_kernel.py",
}
SCRIPTS = {"grad_oracle_cpu.py": "torch_grad_oracle.py"}
NOT_TO_PORT = ("plot_training.py", "plot_scaling.py")
# Each pallas_call site (file:line) -> the CUDA source of its port.
PALLAS_CALLS = {
    "pathtrace_tpu/ops/pallas_trace.py:658": "trace_kernel.cu",  # K1
    "pathtrace_tpu/ops/pallas_grad.py:700": "grad_kernel.cu",  # K2 fused
    "pathtrace_tpu/ops/pallas_grad.py:778": "grad_kernel.cu",  # K2 dump of a slab
    "pathtrace_tpu/ops/pallas_grad.py:857": "grad_kernel.cu",  # K2 dump
    "pathtrace_tpu/ops/pallas_grad.py:929": "grad_kernel.cu",  # K5 replay
    "pathtrace_tpu/ops/pallas_nee_grad.py:800": "nee_grad_kernel.cu",  # K3 fused
    "pathtrace_tpu/ops/pallas_nee_grad.py:818": "nee_grad_kernel.cu",  # K3 replay
    "pathtrace_tpu/ops/pallas_ad.py:250": "ad_grad_kernel.cu",  # K4
    "pathtrace_tpu/utils/roofline.py:431": "probe_kernel.cu",  # K6
    "scripts/fma_probe.py:145": "probe_kernel.cu",  # K7
}
BANNED = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|pathtrace_tpu)(\.|\s|$)", re.M)


def jax_modules():
    return sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))


def jax_scripts():
    return sorted(p.name for p in (REPO / "scripts").iterdir()
                  if p.is_file() and p.suffix in (".py", ".sh") and not p.name.startswith("torch_"))


def pallas_call_sites():
    sites = []
    for path in sorted([*JAX_PKG.rglob("*.py"), *(REPO / "scripts").glob("*.py")]):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"\bpl\.pallas_call\(", line):
                sites.append(f"{path.relative_to(REPO).as_posix()}:{n}")
    return sites


@pytest.mark.parametrize("module", jax_modules())
def test_every_module_has_a_counterpart(module):
    counterpart = PORT_PKG / PALLAS_MODULES.get(module, module)
    assert counterpart.is_file(), f"pathtrace_tpu/{module} has no counterpart {counterpart}"


@pytest.mark.parametrize("script", jax_scripts())
def test_every_script_has_a_counterpart(script):
    if script in NOT_TO_PORT:
        assert not BANNED.search((REPO / "scripts" / script).read_text())
        return
    counterpart = REPO / "scripts" / SCRIPTS.get(script, f"torch_{script}")
    assert counterpart.is_file(), f"scripts/{script} has no counterpart {counterpart.name}"


@pytest.mark.parametrize("site", pallas_call_sites())
def test_every_pallas_call_has_a_cuda_source(site):
    assert site in PALLAS_CALLS, f"{site}: a TPU kernel with no port"
    source = CSRC / PALLAS_CALLS[site]
    assert source.is_file(), f"{site}: {source} does not exist"
    assert site.split(":")[0] in source.read_text(), f"{source.name} does not name {site}"


def test_the_tables_have_no_stale_rows():
    assert sorted(pallas_call_sites()) == sorted(PALLAS_CALLS)
    assert len(PALLAS_CALLS) == 10
    assert set(PALLAS_MODULES) <= set(jax_modules())
    assert set(SCRIPTS) | set(NOT_TO_PORT) <= set(jax_scripts())
