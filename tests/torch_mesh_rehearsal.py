"""The port's side of the mesh tests, without the reference: a rehearsal
for a machine that has another torch than the one the tests ran under
(DTensor's rules differ between versions) and may have no JAX.

    PYTHONPATH=src:tests python tests/torch_mesh_rehearsal.py [OUT_DIR]

Runs, in 4 ``gloo`` processes on the CPU, ``torch_mesh_worker.port_runs``
(Qwen2-7B's smoke train step on (2, 2) and (1, 4), whose k/v projections
split ``head_dim`` on (1, 4), and the checkpoint on (4, 1)) and
``ssm_runs`` on (2, 2) and (1, 4) (the Mamba2 and Hymba cases of
``tests/test_torch_mesh_ssm.py``, without and with each of
``torch_mesh_worker.SSM_OPTIONS``), and ``ssm_one`` in one process; then
holds each SSM case's logits, caches and gradients on the meshes, with
the sequence options and without, against the unsharded port's at the
test file's tolerances (``torch_mesh_worker.SSM_FRAC``), and the (1, 1)
mesh against the unsharded port bit for bit, with the options too.  Prints one line a check and
``REHEARSAL OK`` last; exits 1 at the first check that fails.  Imports
``torch`` and ``repro_torch`` only.
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

import torch_mesh_worker as worker


def _check(ok: bool, what: str) -> None:
    print(f"{'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        sys.exit(1)


def main() -> int:
    out = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix="mesh_rehearsal-")
    os.makedirs(out, exist_ok=True)
    print(f"torch {torch.__version__}; results under {out}", flush=True)
    src = os.path.join(out, "train_in.npz")
    worker.train_inputs(src)
    worker.spawn(worker.port_runs, 4, src, os.path.join(out, "train.npz"),
                 tempfile.mkdtemp(prefix="ckpt-", dir=out))
    got = dict(np.load(os.path.join(out, "train.npz")))
    for t in map(worker.tag, worker.MESHES):
        _check(bool(np.isfinite(got[f"{t}/loss"])), f"port_runs {t}: loss "
               f"{float(got[f'{t}/loss'])}")

    src = os.path.join(out, "ssm_in.npz")
    worker.ssm_inputs(src)
    worker.spawn(worker.ssm_one, 1, src, os.path.join(out, "1x1.npz"))
    one = dict(np.load(os.path.join(out, "1x1.npz")))
    for case in worker.SSM_CASES:
        keys = [k[5:] for k in one if k.startswith(f"mesh/{case}/")]
        _check(all(np.array_equal(one[f"mesh/{k}"], one[f"off/{k}"])
                   for k in keys), f"ssm_one {case}: (1, 1) bit-identical "
               f"to the unsharded port ({len(keys)} arrays)")
        for opts in worker.SSM_OPTIONS:
            pre = f"opt/{case}/{opts}/"
            keys = [k[len(pre):] for k in one if k.startswith(pre)
                    and not k.endswith(("/flash", "/carry"))]
            _check(bool(keys) and all(
                np.array_equal(one[pre + k], one[f"off/{case}/{k}"])
                for k in keys), f"ssm_one {case} {opts}: (1, 1) "
                f"bit-identical to the unsharded port ({len(keys)} arrays)")
    for shape in worker.MESHES:
        t = worker.tag(shape)
        dst = os.path.join(out, f"ssm_{t}.npz")
        worker.spawn(worker.ssm_runs, 4, shape, src, dst,
                     tempfile.mkdtemp(prefix="ckpt-", dir=out))
        got = dict(np.load(dst))
        for case in worker.SSM_CASES:
            for run in (case, *(f"{case}/{o}" for o in worker.SSM_OPTIONS)):
                worst = {}
                for k, frac in worker.SSM_FRAC.items():
                    for key in [x for x in got if x == f"{run}/{k}"
                                or x.startswith(f"{run}/{k}/")]:
                        want = one[f"off/{case}/{key[len(run) + 1:]}"]
                        err = float(np.abs(got[key] - want).max())
                        tol = frac * float(np.abs(want).max())
                        worst[k] = max(worst.get(k, 0.0),
                                       err / max(tol, 1e-30))
                _check(bool(worst) and all(v <= 1 for v in worst.values()),
                       f"ssm_runs {t} {run}: worst error / tolerance "
                       f"{worst}")
            _check(bool(got[f"{case}/grads_bit_identical"]),
                   f"ssm_runs {t} {case}: two backward runs bit-identical")
    print("REHEARSAL OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
