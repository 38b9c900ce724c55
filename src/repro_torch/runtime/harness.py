"""Start ranks of the multi-process runtime and wait for them.

The counterpart of ``repro/runtime/harness.py``.  The reference runs its
multi-device work in a child process that sees N forced host devices; the
port runs N child processes, one a rank, joined by ``torch.distributed``
(``launch.mesh.make_runtime_mesh``).

* :func:`rank_env` builds one rank's environment: ``src`` on
  ``PYTHONPATH``, ``RANK``, ``WORLD_SIZE`` and the rendezvous URL in
  ``REPRO_DIST_INIT``,
* :func:`run_ranks` starts ``python -m <module>`` (or ``python -c
  <source>``) once per rank with ``--backend`` and ``--device`` appended to
  its arguments, waits for all of them and returns their
  ``CompletedProcess``es.  A rank that exits non-zero, or a run that passes
  its ``timeout``, kills every other rank and raises :class:`RankError`,
  so a hung collective cannot eat a caller's clock.

The rendezvous is a ``FileStore`` in a fresh temporary directory: a fixed
TCP port would collide between callers running at once.

The reference's ``ensure_host_devices`` has no counterpart: jax locks its
host device count when it first initializes, so the reference must set
it before importing jax, while torch has no device count to lock (a rank
is a process, and the world size is given to each one).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

from repro_torch.launch.mesh import INIT_ENV

DEFAULT_TIMEOUT = 300.0


class RankError(RuntimeError):
    """A rank failed or the ranks ran past their timeout; ``outputs``
    holds each rank's ``CompletedProcess`` so far (killed ranks included)."""

    def __init__(self, msg: str, outputs):
        super().__init__(msg)
        self.outputs = outputs


def _repo_root() -> str:
    # src/repro_torch/runtime/harness.py -> repo root
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def rank_env(rank: int, world: int, init: str,
             base: dict | None = None) -> dict:
    """Environment of rank ``rank`` of ``world``, meeting the others at
    ``init`` (``file://<path>`` or ``tcp://host:port``)."""
    env = dict(os.environ if base is None else base)
    src = os.path.join(_repo_root(), "src")
    pp = env.get("PYTHONPATH", "")
    if src not in pp.split(os.pathsep):
        env["PYTHONPATH"] = src + (os.pathsep + pp if pp else "")
    env.update(RANK=str(rank), WORLD_SIZE=str(world))
    env[INIT_ENV] = init
    return env


def _command(source: str) -> list[str]:
    if re.fullmatch(r"[A-Za-z_][\w]*(\.[A-Za-z_][\w]*)*", source):
        return [sys.executable, "-m", source]
    return [sys.executable, "-c", source]


def _tail(text: str, n: int = 4000) -> str:
    return text if len(text) <= n else "..." + text[-n:]


def run_ranks(source: str, n_ranks: int, *, backend: str = "gloo",
              device: str = "cpu", timeout: float = DEFAULT_TIMEOUT,
              extra_args: list[str] | None = None
              ) -> list[subprocess.CompletedProcess]:
    """Run ``source`` (a dotted module path, or Python source) as
    ``n_ranks`` ranks from the repository root and wait for all of them.
    Each gets ``--backend <backend> --device <device>`` and then
    ``extra_args``.  Raises :class:`RankError` when any rank exits
    non-zero or the ranks are still running after ``timeout`` seconds,
    after killing every rank still alive."""
    args = ["--backend", backend, "--device", device] + list(extra_args or [])
    tmp = tempfile.mkdtemp(prefix="ranks-")
    init = "file://" + os.path.join(tmp, "store")
    procs, files = [], []
    try:
        for r in range(n_ranks):
            out = open(os.path.join(tmp, f"rank{r}.out"), "w+")
            err = open(os.path.join(tmp, f"rank{r}.err"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen(
                _command(source) + args, stdout=out, stderr=err,
                stdin=subprocess.DEVNULL, text=True, cwd=_repo_root(),
                env=rank_env(r, n_ranks, init)))
        failure = None
        deadline = time.monotonic() + timeout
        while failure is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failure = (f"rank {bad[0]} of {n_ranks} exited with code "
                           f"{codes[bad[0]]}")
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failure = (f"ranks still running after {timeout:.0f} s "
                           f"(ranks {[r for r, c in enumerate(codes) if c is None]})")
            else:
                time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        results = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            results.append(subprocess.CompletedProcess(
                p.args, p.returncode, out.read(), err.read()))
        if failure is not None:
            first = bad[0] if bad else 0
            raise RankError(
                f"{failure}; its stderr:\n"
                f"{_tail(results[first].stderr)}", results)
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
        shutil.rmtree(tmp, ignore_errors=True)
