"""ops.cuda_update: the optimizer update's global-norm clip and EMA.

On the CPU, the plain path (``global_norm_clip_``, ``ema_update_`` and the
train step's ``_clip_by_global_norm`` / ``_update_ema`` through them) is held
bit for bit against the per-tensor loops the train step ran before the
multi-tensor kernels, written out below, and the kernels' tables refuse
a dtype or layout the kernels cannot walk. Tests marked ``card`` hold the
kernels against the plain path on a CUDA card and skip without one; the
suite's conftest imports JAX, which the card's machine lacks, so there they
run as ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_update.py -q``.
"""
import numpy as np
import pytest
import torch

from ood_object_detection_tpu_torch.ops import cuda_update as cu
from ood_object_detection_tpu_torch.train import train_state as tts


def former_clip(grads, max_norm):
    """The train step's clip before the kernels."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if max_norm:
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def former_ema(ema, params, step, decay):
    """The train step's EMA before the kernels, on lists."""
    step_f = np.float32(step) + np.float32(1.0)
    d = min(np.float32(decay), (np.float32(1.0) + step_f)
            / (np.float32(10.0) + step_f))
    one_minus = np.float32(1.0) - d
    for e, p in zip(ema, params):
        e.copy_(e * float(d) + p * float(one_minus))
    return d


SHAPES = {
    "mixed": [(3, 5), (7,), (64, 3, 3, 3), (6, 4)],
    "zero_size": [(0,), (5, 4), (0, 3)],
    "one_element": [(1,)],
    "not_multiple_of_4": [(7,), (13,), (3, 3)],
}
# (shapes, max_norm, whether the clip engages)
CLIP_CASES = {
    "engaged": ("mixed", 0.5, True),
    "not_engaged": ("mixed", 1e6, False),
    "max_norm_0": ("mixed", 0.0, False),
    "zero_size": ("zero_size", 0.5, True),
    "one_element": ("one_element", 0.01, True),
    "not_multiple_of_4": ("not_multiple_of_4", 0.5, True),
}
# (step, decay, whether ``decay`` wins the min)
EMA_CASES = {"step_0": (0, 0.9998, False), "step_1": (1, 0.9998, False),
             "decay_wins": (100_000, 0.9998, True)}


def arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def counters():
    return cu.global_norm_clip_.launches, cu.ema_update_.launches


@pytest.mark.parametrize("case", CLIP_CASES)
def test_global_norm_clip_plain_path_is_the_former_loop(case):
    shapes, max_norm, engaged = CLIP_CASES[case]
    values = arrays(SHAPES[shapes], seed=len(case))
    want, got, via_step = ([torch.from_numpy(a.copy()) for a in values]
                           for _ in range(3))
    before = counters()
    want_norm = former_clip(want, max_norm)
    norm = cu.global_norm_clip_(got, max_norm)
    step_norm = tts._clip_by_global_norm(via_step, max_norm)
    assert counters() == before            # CPU: no launch
    assert norm.shape == () and torch.equal(norm, want_norm)
    assert torch.equal(step_norm, want_norm)
    for g, s, w in zip(got, via_step, want):
        assert torch.equal(g, w) and torch.equal(s, w)
    moved = any(not torch.equal(g, torch.from_numpy(a))
                for g, a in zip(got, values) if a.size)
    assert moved == engaged and (float(norm) >= max_norm) == (
        engaged or max_norm == 0.0)


@pytest.mark.parametrize("case", EMA_CASES)
def test_ema_update_plain_path_is_the_former_loop(case):
    step, decay, decay_wins = EMA_CASES[case]
    shapes = SHAPES["mixed"] + SHAPES["zero_size"] + \
        SHAPES["not_multiple_of_4"]
    model = torch.nn.Module()
    for i, a in enumerate(arrays(shapes, seed=1)):
        model.register_parameter(f"p{i}", torch.nn.Parameter(
            torch.from_numpy(a)))
    start = {n: torch.from_numpy(a) for n, a in
             zip(dict(model.named_parameters()), arrays(shapes, seed=2))}
    state = tts.TrainState(step=step, model=model, optimizer=None,
                           ema_params={n: e.clone() for n, e in start.items()})
    params = list(model.parameters())
    want = [e.clone() for e in start.values()]
    got = [e.clone() for e in start.values()]
    before = counters()
    d = former_ema(want, params, step, decay)
    cu.ema_update_(got, params, d)
    tts._update_ema(state, decay)
    assert counters() == before
    assert (d == np.float32(decay)) == decay_wins
    for g, s, w in zip(got, state.ema_params.values(), want):
        assert torch.equal(g, w) and torch.equal(s, w)
        assert not s.requires_grad


def channels_last_conv(seed):
    return torch.from_numpy(arrays([(8, 4, 3, 3)], seed)[0]).contiguous(
        memory_format=torch.channels_last)


# what the kernels' tables refuse (checked before any launch, so on the
# CPU too): (which table, error, words of its message, the lists)
LAYOUT_FAULTS = {
    "bfloat16": ("one", TypeError, "float32",
                 lambda: [torch.zeros(4),
                          torch.zeros(3, dtype=torch.bfloat16)]),
    "strided": ("one", ValueError, "dense",
                lambda: [torch.zeros(6, 8)[:, ::2]]),
    "pair_count": ("pair", ValueError, "2 EMA tensors for 1",
                   lambda: ([torch.zeros(3), torch.zeros(3)],
                            [torch.zeros(3)])),
    "pair_size": ("pair", ValueError, "not laid out as its parameter",
                  lambda: ([torch.zeros(4)], [torch.zeros(3)])),
    "pair_layout": ("pair", ValueError, "not laid out as its parameter",
                    lambda: ([channels_last_conv(0).contiguous()],
                             [channels_last_conv(0)])),
}


@pytest.mark.parametrize("fault", LAYOUT_FAULTS)
def test_kernel_tables_refuse_what_the_kernels_cannot_walk(fault):
    table, error, says, make = LAYOUT_FAULTS[fault]
    with pytest.raises(error, match=says):
        if table == "one":
            cu._table(make())
        else:
            cu._pair_table(*make())


def test_kernel_tables_take_dense_float32_layouts():
    params = [torch.zeros(0), torch.zeros(7), channels_last_conv(1)]
    ema = [p.clone() for p in params]
    assert not cu._on_card(ema, params) and not cu._on_card([])
    ptrs, sizes = cu._table(params)
    assert list(ptrs) == [p.data_ptr() for p in params]
    assert list(sizes) == [0, 7, 288]
    e_ptrs, p_ptrs, pair_sizes = cu._pair_table(ema, params)
    assert list(e_ptrs) == [e.data_ptr() for e in ema]
    assert list(p_ptrs) == list(ptrs) and pair_sizes == sizes


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when a test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the multi-tensor kernels run only "
                    "there); none on this machine")
    return torch.device("cuda", 0)


def card_tensors(kind, device):
    """D0's 424 parameters as the train step holds them (channels_last
    convolutions), or odd sizes: empty, one value, sizes that are not
    multiples of 4, a chunk and one more, and a view 4 bytes off the
    16-byte alignment the float4 path takes."""
    if kind == "d0":
        from ood_object_detection_tpu_torch.factory import create_model
        bench = create_model("efficientdet_d0", bench_task="train",
                             num_classes=90, seed=0, device=device)
        return [p.detach().clone() for p in bench.model.parameters()]
    gen = torch.Generator(device=device).manual_seed(5)
    out = [torch.randn(s, generator=gen, device=device) for s in
           [(0,), (1,), (7,), (13,), (16385,), (3, 5), (64, 3, 3, 3)]]
    base = torch.randn((4 * 16384 + 6,), generator=gen, device=device)
    return out + [base[1:]]


def clones(tensors):
    """Copies laid out as the originals: the same strides, and a 1-D view
    off the 16-byte alignment copied to a view as far off it."""
    out = []
    for t in tensors:
        off = t.data_ptr() % 16 // t.element_size()
        if off:
            t = torch.empty((t.numel() + off,), dtype=t.dtype,
                            device=t.device)[off:].copy_(t)
        else:
            t = t.clone()
        out.append(t)
    return out


@pytest.mark.card
@pytest.mark.parametrize("kind", ["d0", "odd"])
def test_clip_kernels_match_the_plain_path_on_the_card(card, kind):
    params = card_tensors(kind, card)
    gen = torch.Generator(device=card).manual_seed(6)
    # laid out as their parameters, as autograd lays out a gradient
    grads = [torch.empty_like(p).normal_(generator=gen) for p in params]
    if kind == "odd":                       # the unaligned view again
        grads[-1] = torch.randn((grads[-1].numel() + 1,), generator=gen,
                                device=card)[1:]
    plain_norm = cu.global_norm_plain(grads)
    for max_norm in (0.5 * float(plain_norm), 2.0 * float(plain_norm)):
        before = counters()
        got = clones(grads)
        norm = cu.global_norm_clip_(got, max_norm)
        again = clones(grads)
        norm_again = cu.global_norm_clip_(again, max_norm)
        want = clones(grads)
        cu.clip_scale_plain_(want, norm, max_norm)   # the same norm
        torch.cuda.synchronize()
        assert counters() == (before[0] + 2, before[1])
        assert abs(float(norm) - float(plain_norm)) <= 1e-6 * float(
            plain_norm)
        assert torch.equal(norm, norm_again)        # deterministic
        for g, a, w, g0 in zip(got, again, want, grads):
            assert torch.equal(g, w) and torch.equal(a, g)
            assert torch.equal(g, g0) == (max_norm > float(norm) or
                                          g.numel() == 0)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["d0", "odd"])
def test_ema_kernel_matches_the_plain_path_on_the_card(card, kind):
    params = card_tensors(kind, card)
    ema = [p * 0.5 + 0.25 for p in params]
    if kind == "odd":                       # an unaligned EMA beside it
        ema[-1] = torch.zeros(ema[-1].numel() + 1, device=card)[1:]
        ema[-1].copy_(params[-1] * 0.5)
    for d in (np.float32(0.1), np.float32(0.9998)):
        before = counters()
        got, again, want = clones(ema), clones(ema), clones(ema)
        cu.ema_update_(got, params, d)
        cu.ema_update_(again, params, d)
        cu.ema_update_plain_(want, params, d)
        torch.cuda.synchronize()
        assert counters() == (before[0], before[1] + 2)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(a, g)


@pytest.mark.card
def test_other_layouts_raise_on_the_card(card):
    wide = torch.randn((6, 8), device=card)
    cases = {
        "bfloat16": (TypeError, "float32", [wide.to(torch.bfloat16)]),
        "strided": (ValueError, "dense", [wide[:, ::2]]),
        "two devices": (ValueError, "one CUDA device", [wide, wide.cpu()]),
    }
    launched = counters()
    for name, (error, says, tensors) in cases.items():
        before = [t.clone() for t in tensors]
        with pytest.raises(error, match=says):
            cu.global_norm_clip_(tensors, 1.0)
        with pytest.raises(error, match=says):
            cu.ema_update_(tensors, [t.clone() for t in tensors], 0.5)
        assert all(map(torch.equal, tensors, before)), name
    conv = torch.randn((8, 4, 3, 3), device=card).contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="not laid out as its parameter"):
        cu.ema_update_([conv.contiguous()], [conv], 0.5)
    assert counters() == launched
