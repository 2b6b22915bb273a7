"""The benchmark's plain reference against the port's numpy ``golden``
codec, and the roofline's byte count."""

import numpy as np
import pytest
import torch

from ndzip_tpu_torch import golden
from portbench import roofline
from portbench.reference import codec as reference

SHAPES = [(3 * 4096 + 77,), (130, 200), (64, 128), (33, 40, 50), (16, 32, 48), (10, 12), (5, 6, 7)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_the_reference_stream_is_golden_byte_for_byte(shape, dtype):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    x = (np.sin(np.arange(np.prod(shape)) * 1e-2).reshape(shape) + 1e-3 * rng.standard_normal(shape)).astype(dtype)
    x.reshape(-1)[:50] = 0
    words = torch.from_numpy(x.view(np.int32 if dtype == np.float32 else np.int64))
    stream, length = reference.encode(words)
    ref = stream[: int(length)].numpy().view(np.uint32)
    gold, _ = golden.compress(x)
    assert ref.tobytes() == gold.tobytes()
    back = reference.decode(stream[: int(length)], shape, x.itemsize * 8)
    assert torch.equal(back, words)


def test_roofline_bytes_are_the_formats_whatever_made_the_stream():
    x = np.random.default_rng(3).standard_normal((33, 40, 50)).astype(np.float32)
    stream, length = reference.encode(torch.from_numpy(x.view(np.int32)))
    gold, _ = golden.compress(x)
    by_ref = roofline.codec_bytes(x.size, 4, int(length))
    assert by_ref == roofline.codec_bytes(x.size, 4, gold.size) == x.nbytes + 4 * gold.size
    assert roofline.codec_bytes(10, 8, 3) == 92
    with pytest.raises(ValueError):
        roofline.codec_bytes(10, 2, 3)
