"""The training half's parity with the flash path forced (flash_threshold
32, flash_chunk 16), on the CPU at SMOKE size in float32: `loss_fn` and
its gradients against `jax.value_and_grad` of the reference's, so
`ops.FlashAttentionFn`'s backward (the plain version recomputed chunk by
chunk under `torch.utils.checkpoint`) is held against jax.grad of
`_sdpa_flash` (a scan under `jax.checkpoint`), with fully masked chunks
(causal rows before a chunk, mixtral's window) and the SSD segment sums in
the same models; every gradient must be finite.  Tolerances as in
tests/test_torch_train.py (the helpers live there)."""

import pytest

from test_torch_train import ARCHS, check_loss_and_grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference_with_flash_forced(arch):
    check_loss_and_grads(arch, flash=True)
