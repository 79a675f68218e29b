"""Multi-rank training on the card: a gang of two rank processes sharing
it (the backend rule picks gloo) runs ``bert_tiny`` on the flash trunk
through ``ShardedTrainer`` at dp=2 (and tp=2, fsdp=2,
``gluon.Trainer(kvstore="dist_sync")``), each step equal to the one-rank
``ShardedTrainer``'s on the same global batches.  Marked ``gpu``: the
test skips inside itself without a card.  Imports torch and the port
only:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dist_gpu.py -q
"""

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.tools import dist_bert
from torch_one_thread import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.gpu


def test_two_rank_steps_on_the_card_equal_one_rank(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ref = dist_bert.reference("tiny", 8, 64, 2, dev)
    ranks = dist_bert.drive(str(tmp_path), world=2, batch=8, seq=64,
                            steps=2, timed=1, model="tiny", timeout=300.0)
    for res in ranks:
        assert res["backend"] == "gloo"
        assert "process group backend gloo" in res["log"]
        for path, got in res["check"].items():
            np.testing.assert_allclose(got["losses"], ref["losses"],
                                       rtol=2e-4, atol=2e-5, err_msg=path)
            for k, v in ref["samples"].items():
                np.testing.assert_allclose(got["samples"][k], v, rtol=2e-3,
                                           atol=2e-4, err_msg=f"{path} {k}")
            # bert_tiny's two layers, each step
            assert set(got["launches"].values()) == {2 * 2}, got["launches"]
