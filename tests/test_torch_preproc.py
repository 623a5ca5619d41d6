"""The port's on-device letterbox + normalise vs the JAX package's
``batched_letterbox_normalize``, downscaling and upscaling."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu.data.device_preproc import (
    batched_letterbox_normalize as jax_letterbox,
)
from ood_object_detection_tpu_torch.data.device_preproc import (
    batched_letterbox_normalize,
)

CASES = {
    # canvas (H, W), true (h, w) per image: every scale < 1, then > 1
    "downscale": ((150, 170), [[150, 170], [101, 133]]),
    "upscale": ((90, 100), [[60, 90], [90, 47]]),
}


def _run(case, out_dtype):
    (ch, cw), true_hw = CASES[case]
    rng = np.random.default_rng(len(case))
    canvases = rng.integers(0, 256, (2, ch, cw, 3), dtype=np.uint8)
    true_hw = np.array(true_hw, np.int32)
    ours = batched_letterbox_normalize(
        torch.from_numpy(canvases), torch.from_numpy(true_hw),
        target_hw=(128, 128), out_dtype=out_dtype)
    ref = jax_letterbox(jnp.asarray(canvases), jnp.asarray(true_hw),
                        target_hw=(128, 128), out_dtype=out_dtype)
    return ours, ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_matches_jax(case):
    ours, ref = _run(case, "float32")
    assert ours["image"].dtype == torch.float32
    np.testing.assert_allclose(ours["image"].numpy(), np.asarray(ref["image"]),
                               rtol=0, atol=1e-4)
    for key in ("img_scale", "img_size"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_matches_jax(case):
    """out_dtype bfloat16: the JAX function resamples in bf16, the port in
    f32 and rounds once, so pixels differ by up to two bf16 steps at 255
    (2 counts, 0.034 normalised), and the normalisation rounds twice more
    in bf16 (up to 0.016 at |x| < 2.2): held to atol 0.06 on the
    normalised image (0.047 measured on these inputs)."""
    ours, ref = _run(case, "bfloat16")
    assert ours["image"].dtype == torch.bfloat16
    got = ours["image"].to(torch.float32).numpy()
    want = np.asarray(ref["image"].astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=0.06)
    assert np.mean(np.abs(got - want)) < 5e-3
