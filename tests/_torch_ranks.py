"""Two (or more) gloo ranks of the port on the CPU, for the multi-process
tests.

:func:`run_ranks` starts P processes of this file, each joining the
process group through ``FEDTPU_DISTRIBUTED=1`` and the three
``FEDTPU_*`` variables, with a ``file://`` store under the test's
``tmp_path`` (no port to race for under xdist).  Each rank pins one torch
thread, runs one program of :data:`PROGRAMS` and pickles what it returns;
every wait has a timeout.  The same programs run in the test's own process
without a process group, on the one-process :class:`ClientMesh`: that is
the reference the ranks are held to, bit for bit.

Every program builds its inputs from a seed with numpy, the same full
arrays on every process, and stages only the process's own rows.
"""

import importlib
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

class Ranks:
    """P rank processes of one program, started; :meth:`wait` collects
    their results in rank order.  A rank that fails, or outlives the
    timeout, fails the wait with every rank's output."""

    def __init__(self, tmp_path, prog: str, P: int = 2, timeout: float = 90.0,
                 env=None, **kwargs):
        self.prog, self.timeout = prog, timeout
        store = os.path.join(str(tmp_path), f"store-{prog}-{os.getpid()}")
        self.procs, self.outs = [], []
        for r in range(P):
            out = os.path.join(str(tmp_path), f"{prog}-rank{r}.pkl")
            self.outs.append(out)
            e = dict(os.environ, FEDTPU_DISTRIBUTED="1",
                     FEDTPU_COORDINATOR=f"file://{store}",
                     FEDTPU_NUM_PROCESSES=str(P), FEDTPU_PROCESS_ID=str(r),
                     OMP_NUM_THREADS="1", **(env or {}))
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), prog,
                 json.dumps(kwargs), out],
                env=e, cwd=str(tmp_path), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))

    def wait(self) -> list:
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            raise AssertionError(
                f"rank(s) {bad} of {self.prog!r} failed:\n" + "\n".join(
                    f"--- rank {r} (rc {p.returncode}) ---\n{log[-4000:]}"
                    for r, (p, log) in enumerate(zip(self.procs, logs))))
        res = []
        for out in self.outs:
            # a rank that left on purpose (a lost peer) wrote nothing
            if not os.path.exists(out):
                res.append(None)
                continue
            with open(out, "rb") as f:
                res.append(pickle.load(f))
        return res


def run_ranks(tmp_path, prog: str, P: int = 2, timeout: float = 90.0,
              env=None, **kwargs) -> list:
    """Run program ``prog`` with ``kwargs`` on P ranks; returns each
    rank's result in rank order."""
    return Ranks(tmp_path, prog, P, timeout, env, **kwargs).wait()


def run_local(prog: str, **kwargs):
    """The same program in this process, on the one-process mesh."""
    from _torch_engine_pair import torch_threads

    with torch_threads(1):
        return PROGRAMS[prog](**kwargs)


# ---------------------------------------------------------------------------
# the programs (each rank's and the reference's)
# ---------------------------------------------------------------------------

def _mesh(D):
    from federated_pytorch_test_tpu_torch.parallel.mesh import client_mesh

    return client_mesh(D)


def _own(mesh, a):
    """This process's rows of the full seeded array ``a``."""
    from federated_pytorch_test_tpu_torch.parallel.mesh import stage_global

    return stage_global(a, "cpu", mesh)


def collectives(D: int, seed: int = 0) -> dict:
    """Every collective of the mesh on seeded parts, keyed by what each
    device holds after it (replicated results under device -1)."""
    mesh = _mesh(D)
    rng = np.random.default_rng(seed)
    K, n = 2 * D, 37
    x = rng.normal(size=(K, n)).astype(np.float32)
    xs = mesh.shards(_own(mesh, x))
    parts = [s.sum(dim=0) for s in xs]
    out = {("psum", -1): mesh.psum(parts).numpy(),
           ("gather", -1): mesh.all_gather(parts).numpy(),
           ("gather_untiled", -1): mesh.all_gather(parts, tiled=False).numpy(),
           ("rows", -1): mesh.gather_rows(_own(mesh, x)).numpy()}
    for d, slab in zip(mesh.indices(), mesh.all_to_all(_own(mesh, x))):
        out[("all_to_all", d)] = slab.numpy()
    for name, perm in (("shift", [(i, (i + 1) % D) for i in range(D)]),
                       ("xor", [(i, i ^ 1) for i in range(D)])):
        sent = [(s[0].clone(), s[-1].to(torch.float64)) for s in xs]
        got = mesh.ppermute(sent, perm)
        for d in mesh.indices():
            out[(name, d)] = tuple(t.numpy() for t in got[d])
    seg = -(-n // D)
    bufs = [torch.nn.functional.pad(p, (0, D * seg - n)) for p in parts]
    for d, s in zip(mesh.indices(), mesh.reduce_scatter(bufs)):
        out[("reduce_scatter", d)] = s.numpy()
    return out


def packed_mean(D: int, bits: int = 8, chunk: int = 64, n: int = 1000,
                weighted: bool = False, seed: int = 1) -> np.ndarray:
    """The fused quantized mean (plain versions) of a seeded stack."""
    from federated_pytorch_test_tpu_torch.ops import quant
    from federated_pytorch_test_tpu_torch.ops.packed_reduce import (
        _weighted_local_sum,
        packed_fused_mean,
    )

    mesh = _mesh(D)
    rng = np.random.default_rng(seed)
    K = 2 * D
    x = _own(mesh, rng.normal(size=(K, n)).astype(np.float32))
    w = (_own(mesh, (rng.random(K) > 0.3).astype(np.float32))
         if weighted else None)
    local, div = _weighted_local_sum(x, w, K, mesh)
    return packed_fused_mean(local, div, mesh, bits, chunk,
                             quant.PLAIN).numpy()


def robust(D: int, kind: str = "krum", chunked: bool = True,
           seed: int = 2) -> np.ndarray:
    """A robust estimator over a seeded stack with one poisoned client and
    one inactive client."""
    from federated_pytorch_test_tpu_torch.parallel.comm import make_robust_mean

    mesh = _mesh(D)
    rng = np.random.default_rng(seed)
    K = 2 * D
    x = rng.normal(size=(K, 301)).astype(np.float32)
    x[1] *= 50.0
    w = np.ones(K, np.float32)
    w[-1] = 0.0
    fn = make_robust_mean(kind, trim_frac=0.2, chunked=chunked, mesh=mesh)
    return fn(_own(mesh, x), _own(mesh, w)).numpy()


def sharded(D: int, weights: str = "none", seed: int = 3) -> np.ndarray:
    from federated_pytorch_test_tpu_torch.parallel.comm import (
        sharded_federated_mean,
    )

    mesh = _mesh(D)
    x, w = sharded_inputs(weights, seed)
    return sharded_federated_mean(
        _own(mesh, x), None if w is None else _own(mesh, w), K=x.shape[0],
        mesh=mesh).numpy()


def sharded_inputs(weights: str, seed: int = 3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(8, 301)).astype(np.float32)
    w = {"none": None,
         "some": np.array([1, 0, 0.5, 1, 0, 0.25, 1, 1], np.float32),
         "all_rejected": np.zeros(8, np.float32)}[weights]
    return x, w


def norms(D: int, seed: int = 4) -> dict:
    """``per_client_norms`` (gathered whole) and ``all_clients_dot``."""
    from federated_pytorch_test_tpu_torch.parallel.comm import (
        all_clients_dot,
        per_client_norms,
    )

    mesh = _mesh(D)
    a, b, ref = norm_inputs(seed)
    return {"norms": mesh.gather_rows(
                per_client_norms(_own(mesh, a), torch.from_numpy(ref),
                                 mesh)).numpy(),
            "dot": all_clients_dot(_own(mesh, a), _own(mesh, b),
                                   mesh).numpy()}


def norm_inputs(seed: int = 4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(8, 129)).astype(np.float32),
            rng.normal(size=(8, 129)).astype(np.float32),
            rng.normal(size=129).astype(np.float32))


def rows(K: int, D: int) -> dict:
    """``local_client_rows`` and the stage -> fetch round trip."""
    from federated_pytorch_test_tpu_torch.parallel.mesh import (
        fetch,
        local_client_rows,
        stage_global,
    )

    mesh = _mesh(D)
    full = np.arange(K * 3, dtype=np.float32).reshape(K, 3)
    staged = stage_global(full, "cpu", mesh)
    return {"rows": local_client_rows(mesh, K), "staged": staged.numpy(),
            "fetched": fetch(staged, mesh)}


class Killed(Exception):
    """Raised from the log on the kill line."""


def _strip(hist) -> list:
    """The records without what measures a process (times, its own kernel
    launches)."""
    return [{k: v for k, v in r.items()
             if not k.endswith("_seconds") and k != "kernel_launches"}
            for r in hist]


def driver(module: str, argv: list, kill_at=None) -> dict:
    """Run driver ``module``'s ``main(argv)``: its records, the whole K-client
    parameters (gathered from the ranks), its log.  ``kill_at``: raise
    from the log on the first line holding that text (a kill after that
    round's checkpoint)."""
    from federated_pytorch_test_tpu_torch.utils.tree import tree_map

    mod = importlib.import_module(
        f"federated_pytorch_test_tpu_torch.drivers.{module}")
    lines = []
    try:
        trainer, state, hist = mod.main(list(argv),
                                        log=_killer(lines, kill_at))
    except Killed:
        return {"killed": True, "lines": lines}
    if isinstance(state, dict):                      # the CPC's sub-models
        full = lambda t: tree_map(lambda v: trainer._full_leaf(v).numpy(), t)
        params = {m: full(state[m]) for m in state}
    else:
        params = _full_params(trainer, state)
    return {"hist": _strip(hist), "params": params, "lines": lines,
            "D": trainer.D, "processes": trainer.mesh.processes}


def _full_params(trainer, state) -> dict:
    from federated_pytorch_test_tpu_torch.utils.tree import tree_map

    full = lambda t: tree_map(lambda v: trainer._full_leaf(v).numpy(), t)
    return {"params": full(state.params),
            "batch_stats": full(state.batch_stats)}


def _killer(lines: list, kill_at):
    def log(m):
        lines.append(m)
        if kill_at is not None and kill_at in m:
            raise Killed(m)
    return log


def _trainer(cfg: dict, data: dict, algo: str, blocks: int):
    """The classifier engine on Net over its first ``blocks`` blocks."""
    from federated_pytorch_test_tpu_torch.data.cifar10 import (
        FederatedCifar10,
    )
    from federated_pytorch_test_tpu_torch.models.simple import Net
    from federated_pytorch_test_tpu_torch.train import algorithms
    from federated_pytorch_test_tpu_torch.train.config import FederatedConfig
    from federated_pytorch_test_tpu_torch.train.engine import (
        BlockwiseFederatedTrainer,
    )

    tt = BlockwiseFederatedTrainer(
        Net(), FederatedConfig(device="cpu", **cfg), FederatedCifar10(**data),
        getattr(algorithms, algo)())
    tt.L = blocks
    return tt


def engine(cfg: dict, data: dict, algo: str, blocks: int, start=None,
           checkpoint=None, resume: bool = False, kill_at=None) -> dict:
    """The classifier engine (the port's side of
    ``_torch_engine_pair.run_both``): ``start`` a pickle of the JAX
    layout's ``(params, batch_stats)`` to start from,
    ``checkpoint``/``resume`` the mid-run checkpoint, ``kill_at`` as
    :func:`driver`'s."""
    from federated_pytorch_test_tpu_torch import bridge
    from federated_pytorch_test_tpu_torch.train.engine import ClientState
    from federated_pytorch_test_tpu_torch.utils.tree import tree_map

    tt = _trainer(cfg, data, algo, blocks)
    state = None
    if start is not None:
        _await(start)
        with open(start, "rb") as f:
            p0, b0 = pickle.load(f)
        state = ClientState(*[tree_map(tt._own_leaf, t) for t in
                              bridge.classifier_state_from_jax(p0, b0)])
    lines = []
    try:
        state, hist = tt.run(state, log=_killer(lines, kill_at),
                             checkpoint_path=checkpoint, resume=resume)
    except Killed:
        return {"killed": True, "lines": lines}
    return {"hist": _strip(hist), "params": _full_params(tt, state),
            "lines": lines}


def _await(path: str, timeout: float = 120.0) -> None:
    """Wait for a file the test process writes while the ranks run."""
    import time

    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.1)


def copy(src: str, dst: str) -> None:
    """Copy a checkpoint directory on rank 0 while the others wait."""
    import shutil

    from federated_pytorch_test_tpu_torch.parallel.mesh import (
        process_index,
        sync_global,
    )

    if process_index() == 0:
        shutil.copytree(src, dst)
    sync_global("copied")


def vae(argv: list, blocks: int = 1) -> dict:
    """``federated_vae``'s trainer from ``argv`` over its first
    ``blocks`` layers."""
    from federated_pytorch_test_tpu_torch.drivers import federated_vae

    t = federated_vae.build(list(argv))
    t.L = blocks
    state, hist = t.run(t.init_state(), log=lambda m: None)
    return {"hist": _strip(hist), "params": _full_params(t, state)}


def bundle(calls: list) -> list:
    """Several programs in one process: ``calls`` of ``[name, kwargs]``."""
    return [PROGRAMS[name](**kw) for name, kw in calls]


def lost_in_round(cfg: dict, data: dict, algo: str, blocks: int,
                  checkpoint: str) -> dict:
    """Rank 1 leaves once round 0's checkpoint is durable (its log line
    comes after the save's last barrier); rank 0's next round must raise
    the typed error at its bounded fence, naming the round."""
    import time

    from federated_pytorch_test_tpu_torch.parallel import mesh as m

    tt = _trainer(cfg, data, algo, blocks)
    lines, at = [], {}

    def log(msg):
        lines.append(msg)
        if "round=0/" in msg:
            at["t"] = time.monotonic()
            if m.process_index() == 1:
                sys.stdout.flush()
                os._exit(0)

    try:
        tt.run(log=log, checkpoint_path=checkpoint)
    except m.CollectiveTimeoutError as e:
        return {"error": str(e), "round_index": e.round_index,
                "seconds": time.monotonic() - at["t"], "lines": lines,
                "count": m.collective_timeout_count()}
    return {"error": None, "lines": lines}


def dead_peer(bound: float = 8.0) -> dict:
    """Rank 1 exits after the warm-up barrier; rank 0's bounded
    ``sync_global`` must raise the typed error naming the site."""
    import time

    from federated_pytorch_test_tpu_torch.parallel import mesh as m

    m.sync_global("warm-up")
    if m.process_index() == 1:
        sys.stdout.flush()
        os._exit(0)
    m.configure_barrier_timeout(bound)
    t0 = time.monotonic()
    try:
        m.sync_global("dead-peer")
    except m.CollectiveTimeoutError as e:
        return {"error": str(e), "seconds": time.monotonic() - t0,
                "count": m.collective_timeout_count()}
    return {"error": None}


PROGRAMS = {f.__name__: f for f in (collectives, packed_mean, robust,
                                    sharded, norms, rows, driver, engine,
                                    copy, vae, bundle, lost_in_round,
                                    dead_peer)}

#: the programs that lose a peer: the survivor leaves without the group's
#: teardown, which would wait for the peer
LOSE_A_PEER = ("dead_peer", "lost_in_round")


def _main() -> None:
    prog, kwargs, out = sys.argv[1:]
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from federated_pytorch_test_tpu_torch.parallel.mesh import (
        initialize_multihost,
        process_index,
    )

    assert initialize_multihost("cpu")
    res = PROGRAMS[prog](**json.loads(kwargs))
    with open(out, "wb") as f:
        pickle.dump(res, f)
    if prog in LOSE_A_PEER and process_index() == 0:
        # the peer is gone: leave without the group's teardown
        sys.stdout.flush()
        os._exit(0)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    _main()
