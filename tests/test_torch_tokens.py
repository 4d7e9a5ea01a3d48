"""The port's synthetic token pipeline (``data/tokens.py``) against the
JAX package's: the same batches bit for bit from the same seed, and no
producer thread left once the generator is closed."""
import threading

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.data.tokens import synthetic_token_batches as j_batches
from repro_torch import configs
from repro_torch.data.tokens import PRODUCER_THREAD, synthetic_token_batches


def _producers():
    return [t for t in threading.enumerate() if t.name == PRODUCER_THREAD]


@pytest.mark.parametrize("seed", [0, 17])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "musicgen-large"])
def test_first_batches_equal_jax(arch, seed):
    """Tokens and labels (qwen2), frame embeddings and labels (musicgen):
    the first three batches, keys, dtypes and values, bit for bit."""
    ours = synthetic_token_batches(configs.get_smoke_config(arch), 3, 48,
                                   seed=seed)
    ref = j_batches(jconfigs.get_smoke_config(arch), 3, 48, seed=seed)
    try:
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert sorted(a) == sorted(b)
            for k in b:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        ours.close()
        ref.close()
    assert not _producers()


def test_close_stops_the_producer():
    """A generator with a full prefetch queue: ``close()`` returns once its
    producer thread has ended; an unstarted generator starts none."""
    cfg = configs.get_smoke_config("qwen2-0.5b")
    idle = synthetic_token_batches(cfg, 2, 16)
    assert not _producers()
    it = synthetic_token_batches(cfg, 2, 16, prefetch=1)
    first = next(it)
    assert first["tokens"].shape == (2, 16) and len(_producers()) == 1
    it.close()
    idle.close()
    assert not _producers()
    with pytest.raises(StopIteration):
        next(it)
