"""Start a local world of ranks and collect what each returns.

The JAX package runs its mesh as one program (``shard_map``) and its
multi-process test through ``tests/multihost_worker.py``. Here a world is
``n`` fresh Python processes (``python -m pathtrace_tpu_torch.parallel.
launch``, the spawn start method's fresh interpreter), each of which:

- reads its job (a function of an importable module of the package, its
  arguments) from a pickle the parent wrote;
- sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT``, and joins the process group through
  ``mesh.initialize_multihost`` on a free port of this host;
- on the CPU takes one thread (``torch.set_num_threads(1)``), so that a
  world of 4 under several test workers does not oversubscribe the host;
- runs the function and pickles its result, or its traceback.

So a child imports torch and the port only: never the caller's module.
``launch`` raises in the caller with the traceback of the first rank that
failed, and kills every rank of a world that is not done within its
timeout. The backend is chosen explicitly (``choose_backend``) and printed.
"""

from __future__ import annotations

import math
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional

import torch

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_TIMEOUT_S = 600


def choose_backend(n: int, device=None) -> str:
    """``"nccl"`` where each of ``n`` ranks has a card of its own, else
    ``"gloo"``: on the CPU, and for several ranks that share one card (NCCL
    refuses two ranks on one device). ``device`` None is the card."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if torch.cuda.is_available() and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def free_port() -> int:
    """A TCP port of localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(fn: Callable, n: int, *args, device=None, backend: Optional[str] = None,
           timeout_s: Optional[float] = DEFAULT_TIMEOUT_S, quiet: bool = False,
           **kwargs) -> List:
    """Run ``fn(*args, **kwargs)`` on every rank of a new local world of ``n``
    ranks -> the list of what each rank returned, by rank.

    ``fn`` must be a module-level function of an importable module (it is
    named, not pickled by value; a module run with ``python -m`` is named by
    its import name). ``device`` is the ranks' device (None: the
    card, ``"cpu"``); it is given to ``fn`` as the keyword ``device``.
    ``backend`` None is ``choose_backend(n, device)``. ``timeout_s`` bounds
    the world and each of its collectives; None sets no bound on the world
    (a training run) and ``mesh.DEFAULT_TIMEOUT_S`` on a collective."""
    module = getattr(fn, "__module__", None)
    if module == "__main__":  # run with -m: the child imports it by its name
        spec = getattr(sys.modules["__main__"], "__spec__", None)
        module = spec.name if spec is not None else None
    if module in (None, "__main__") or "<" in fn.__qualname__:
        raise ValueError(f"{fn!r} is not a module-level function of an importable module")
    backend = choose_backend(n, device) if backend is None else backend
    if not quiet:
        print(f"launch: a world of {n} rank(s) on {device or 'the card'}, backend {backend}",
              flush=True)
    with tempfile.TemporaryDirectory(prefix="pathtrace_world_") as tmp:
        job = Path(tmp, "job.pkl")
        job.write_bytes(pickle.dumps((module, fn.__qualname__, args,
                                      dict(kwargs, device=device), backend, timeout_s)))
        port = free_port()
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n),
                   PYTHONPATH=os.pathsep.join([str(REPO_ROOT)] + [
                       p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        procs = []
        try:
            for rank in range(n):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "pathtrace_tpu_torch.parallel.launch", str(job),
                     str(Path(tmp, f"rank{rank}.pkl"))],
                    env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank))))
            deadline = time.monotonic() + (math.inf if timeout_s is None else timeout_s)
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break  # one rank failed: the others would wait on it
                if time.monotonic() > deadline:
                    raise RuntimeError(f"a world of {n} ranks was not done within "
                                       f"{timeout_s} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results, errors = [], []
        for rank, p in enumerate(procs):
            out = Path(tmp, f"rank{rank}.pkl")
            if out.exists():
                ok, value = pickle.loads(out.read_bytes())
                if ok:
                    results.append(value)
                    continue
                errors.append(f"rank {rank} of {n} failed:\n{value}")
            else:
                errors.append(f"rank {rank} of {n} exited {p.returncode} with no result")
        if errors:
            # The rank that raised first names the fault; the others
            # mostly report that their collective lost its partner.
            raise RuntimeError("\n".join(errors))
        return results


def _to_host(value):
    """Tensors of a result moved to the CPU, so that the parent, which may
    have no card, can unpickle it."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    return value


def _child(job_path: str, out_path: str) -> int:
    from pathtrace_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, initialize_multihost

    module, qualname, args, kwargs, backend, timeout_s = pickle.loads(
        Path(job_path).read_bytes())
    try:
        device = kwargs.get("device")
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        # The address is given, so that a world of one joins a group too.
        initialize_multihost(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                             int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), backend,
                             DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)
        import importlib

        fn = importlib.import_module(module)
        for part in qualname.split("."):
            fn = getattr(fn, part)
        result = (True, _to_host(fn(*args, **kwargs)))
        code = 0
    except Exception:  # noqa: BLE001 - the boundary of a rank: report the traceback
        result = (False, traceback.format_exc())
        code = 1
    tmp = out_path + ".part"
    Path(tmp).write_bytes(pickle.dumps(result))
    os.replace(tmp, out_path)
    import torch.distributed as dist

    if code == 0 and dist.is_initialized():
        dist.destroy_process_group()
    return code


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1], sys.argv[2]))
