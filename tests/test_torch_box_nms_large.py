"""Box NMS past 4096 candidates, which JAX's `s2d_tpu/ops/boxes.box_nms`
(a loop) takes at any N and K4 on the card now takes too: on the CPU the
port's `ops/boxes.box_nms` (the plain loop for CPU tensors) at N = 4097
against JAX's, seeded boxes with score ties. Tolerance: the keep mask
exactly. The card's side (K4 at 4097, 6000 and 8192 against the plain loop)
is in tests/test_torch_cuda.py."""
import numpy as np
import torch

import jax.numpy as jnp

from s2d_tpu.ops.boxes import box_nms as jax_box_nms

from s2d_tpu_torch.ops.boxes import box_nms


def test_box_nms_past_4096_equals_jax():
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    n = 4097
    xy = rng.uniform(0, 448, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 160, (n, 2))], 1).astype(np.float32)
    scores = (np.round(rng.rand(n) * 64) / 64).astype(np.float32)  # ties
    want = np.asarray(jax_box_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.7))
    got = box_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.7).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < n
