"""Fixtures shared by the tests of pyrenderer_tpu_torch (tests/test_torch_*.py)."""

import os
import subprocess
import sys
import time

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def private_jax_native_cache(tmp_path_factory):
    """The JAX package compiles its native builders (g++, at first use in a
    process) into PYRENDERER_TPU_CACHE, by default one directory that every
    test process shares, where a process can load a library another one is
    still writing. A module that imports this fixture builds them in a
    directory of its own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYRENDERER_TPU_CACHE", str(tmp_path_factory.mktemp("jax_native")))
        yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn_world(target: str, world: int, out_dir, timeout: float = 300.0):
    """Run the function `target` ("module:function", importable from the
    repo's root, importing no JAX) as `world` ranks of a gloo world on the
    CPU: process r calls function(r, world, init, out_dir) with init a
    file:// rendezvous in out_dir, and must return 0. All ranks start at
    once; after `timeout` seconds the survivors are killed (a rank that
    waits in a collective for another that failed would wait for ever).
    Returns the per-rank results function saved as out_dir/rank{r}.pt."""
    module, fn = target.split(":")
    out_dir = str(out_dir)
    init = "file://" + os.path.join(out_dir, "pg")
    procs = []
    try:
        for r in range(world):
            code = (f"import sys; sys.path.insert(0, {REPO!r}); import {module} as m; "
                    f"sys.exit(m.{fn}({r}, {world}, {init!r}, {out_dir!r}))")
            log = open(os.path.join(out_dir, f"rank{r}.log"), "w+")
            procs.append((subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=log,
                                           stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + timeout
        for p, _ in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
        for r, (p, log) in enumerate(procs):
            log.seek(0)
            assert p.returncode == 0, f"rank {r} of {target} exited {p.returncode}:\n" \
                                      f"{log.read()[-4000:]}"
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(world)]
