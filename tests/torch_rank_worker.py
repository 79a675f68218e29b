"""One rank of a gloo gang on the host, for the port's multi-rank tests.

``python tests/torch_rank_worker.py SUITE OUTDIR`` with the launch
variables ``MXTPU_COORDINATOR`` / ``MXTPU_NUM_WORKERS`` /
``MXTPU_WORKER_RANK`` set: the rank joins the process group, runs every
case of SUITE (``dist`` or ``sharding``) in order and writes each case's
arrays to ``OUTDIR/<case>.<rank>.npz`` (or its error to
``OUTDIR/<case>.<rank>.err``).  It imports the port and numpy only.  The
inputs and the initial weights come from numpy seeds the parity tests
share (``torch_rank_cases``).
"""

import os
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_rank_cases as cases  # noqa: E402


def main():
    suite, outdir = sys.argv[1], sys.argv[2]
    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import distributed

    with mx.cpu():
        assert distributed.init_from_env()
        rank = distributed.rank()
        for name, fn in cases.SUITES[suite]:
            try:
                out = fn(rank)
            except Exception:                  # reported by the test
                with open(os.path.join(outdir, f"{name}.{rank}.err"),
                          "w") as f:
                    f.write(traceback.format_exc())
                continue
            if out is not None:
                np.savez(os.path.join(outdir, f"{name}.{rank}.npz"),
                         **{k: np.asarray(v) for k, v in out.items()})
        distributed.barrier("suite_end")


if __name__ == "__main__":
    main()
