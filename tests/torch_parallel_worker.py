"""Multi-process gloo worlds of the PyTorch port on the CPU, for the
``tests/test_torch_parallel_*.py`` files.  Torch and the port only: the
worker processes never import JAX (the pytest process does, through
conftest.py), so they are started as fresh interpreters,

    python -m tests.torch_parallel_worker DIR CASE

one per rank, with torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``) set; each reads ``DIR/payload.pkl``, runs
``CASES[CASE]`` and writes ``DIR/out<rank>.pkl``.  :func:`start_world`
launches them (a free port from binding to port 0), :meth:`World.results`
waits with a timeout and kills every rank on a failure, so a hang fails the
test instead of eating the suite's clock.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLECTIVE_TIMEOUT_S = 60.0


class World:
    def __init__(self, procs, tmp, n, timeout):
        self.procs, self.tmp, self.n, self.timeout = procs, tmp, n, timeout
        self.t0 = time.time()

    def results(self) -> List[Any]:
        """Every rank's result, in rank order; raises (with the ranks'
        stderr) when a rank fails or the world outlives its timeout."""
        try:
            for p in self.procs:
                left = max(self.timeout - (time.time() - self.t0), 1.0)
                p.wait(timeout=left)
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        errs = []
        for r in range(self.n):
            with open(os.path.join(self.tmp.name, f"err{r}.txt"), errors="replace") as f:
                errs.append(f.read())
        if any(p.returncode for p in self.procs):
            raise RuntimeError("a rank failed:\n" + "\n".join(
                f"--- rank {r} (exit {p.returncode}) ---\n{e[-4000:]}"
                for r, (p, e) in enumerate(zip(self.procs, errs))))
        outs = []
        for r in range(self.n):
            with open(os.path.join(self.tmp.name, f"out{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        self.tmp.cleanup()
        return outs


def start_world(n: int, case: str, payload: Dict[str, Any], timeout: float = 150.0) -> World:
    """Launch ``n`` gloo ranks running ``CASES[case](payload)``."""
    tmp = tempfile.TemporaryDirectory(prefix="wm_world_")
    with open(os.path.join(tmp.name, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1")
        with open(os.path.join(tmp.name, f"err{r}.txt"), "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_parallel_worker", tmp.name, case],
                cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=err))
    return World(procs, tmp, n, timeout)


# ---------------------------------------------------------------------------
# The ranks' side
# ---------------------------------------------------------------------------

def _model(payload):
    import torch

    from whisper_medusa_tpu_torch import config as tconfig
    from whisper_medusa_tpu_torch.models import bridge
    from whisper_medusa_tpu_torch.models.api import WhisperMedusaModel

    cfg = tconfig.ModelConfig.from_dict(payload["config"])
    params = bridge._unflatten({k: torch.from_numpy(np.array(v))
                                for k, v in payload["params"].items()})
    return WhisperMedusaModel(cfg, params, device="cpu")


_OUT_FIELDS = ("sequences", "lengths", "accepted", "steps", "steps_per_example",
               "token_logprobs", "mean_accept_length", "detected_language")


def _summary(out) -> Dict[str, Any]:
    return {k: getattr(out, k) for k in _OUT_FIELDS}


def case_generate(payload):
    """``payload["runs"]``: (dp, tp, int8, features, generate kwargs); each
    run shards a fresh model on a mesh of the world and generates."""
    from whisper_medusa_tpu_torch.parallel import mesh as mesh_mod

    res = []
    for dp, tp, int8, feats, kw in payload["runs"]:
        model = _model(payload)
        if int8:
            model = model.quantize()
        model.shard(mesh_mod.make_mesh(dp * tp, dp=dp, tp=tp))
        res.append(_summary(model.generate(feats, **kw)))
    return res


def case_train(payload):
    """MedusaTrainer(mesh=) over ``payload["batches"]`` (global batches, in
    turn); the history and, when asked, generate on the trained model
    under ``payload["serve"]`` = (dp, tp, features, kwargs)."""
    import torch

    from whisper_medusa_tpu_torch.models import bridge
    from whisper_medusa_tpu_torch.parallel import mesh as mesh_mod
    from whisper_medusa_tpu_torch.training.trainer import MedusaTrainer, TrainingArgs

    model = _model(payload)
    dp, tp = payload["mesh"]
    batches = payload["batches"]

    def it():
        i = 0
        while True:
            yield batches[i % len(batches)]
            i += 1

    targs = TrainingArgs(**payload["args"])
    tr = MedusaTrainer(model.config, model.params, targs, it(),
                       mesh=mesh_mod.make_mesh(dp * tp, dp=dp, tp=tp))
    tr.train()
    out = {"history": tr.history}
    if payload.get("return_params"):
        out["params"] = {k: v.detach().float().numpy()
                         for k, v in bridge.flatten(tr.state.params).items()}
    if payload.get("serve"):
        sdp, stp, feats, kw = payload["serve"]
        with torch.no_grad():
            model.params = tr.state.params
            model.shard(mesh_mod.make_mesh(sdp * stp, dp=sdp, tp=stp))
            out["generate"] = _summary(model.generate(feats, **kw))
    return out


def case_cli(payload):
    """The CLI ``payload["cli"]`` (``"evaluate"`` or ``"train"``) with each
    of ``payload["argvs"]``; it joins the world itself (``--dist-backend``,
    torchrun's variables)."""
    import importlib

    cli = importlib.import_module(f"whisper_medusa_tpu_torch.cli.{payload['cli']}")
    return [cli.main(argv) for argv in payload["argvs"]]


CASES = {"generate": case_generate, "train": case_train, "cli": case_cli}


def main(argv=None):
    import torch

    from whisper_medusa_tpu_torch.parallel import distributed

    d, case = (argv or sys.argv[1:])[:2]
    torch.set_num_threads(1)
    with open(os.path.join(d, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    if case != "cli":
        distributed.initialize(backend="gloo", timeout_s=COLLECTIVE_TIMEOUT_S)
    out = CASES[case](payload)
    rank = distributed.process_index()
    distributed.sync()
    with open(os.path.join(d, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    distributed.shutdown()


if __name__ == "__main__":
    main()
