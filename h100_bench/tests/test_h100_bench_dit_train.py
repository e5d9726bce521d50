"""The ``train_models`` driver's cell (``dit-xl2-256-train.epoch-b32``): the
faults its check must catch, its controls, the byte count behind
``adaln_backward_roofline`` and the kernel names behind
``optimizer_share``."""

import numpy as np
import pytest
import torch

from h100_bench import harness
from h100_bench.reference import dit as ref_dit
from h100_bench.tests.tiny import tiny_cell
from h100_bench.yardstick.adaln_bytes import adaln_backward_bytes, dit_step_backward_bytes
from h100_bench.yardstick.optimizer_kernels import is_optimizer

CELL = "dit-xl2-256-train.epoch-b32"
SEED = 2 ** 31 + 2 ** 20 + 17


def _run(**kw):
    return harness.run_cell(tiny_cell(CELL), SEED, 0.3, False, "cpu", **kw)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "labels_dropped",
                                   "ema_skipped"])
def test_dit_train_faults_are_caught(monkeypatch, fault):
    from distillation_trajectories_torch.models.dit import DiT
    from distillation_trajectories_torch.training import state

    if fault == "state_unchanged":  # the gradients taken, no step made
        def update(st, loss, ema_rate):
            st.optimizer.zero_grad(set_to_none=False)
            loss.backward()
        monkeypatch.setattr(state, "_update", update)
    elif fault == "half_batch":  # the loss over the first half of the batch
        orig = state.hybrid_terms

        def half(out, *a):
            n = out.shape[0] // 2
            return tuple(v[:n] for v in orig(out, *a))
        monkeypatch.setattr(state, "hybrid_terms", half)
    elif fault == "labels_dropped":  # every sample trains on the null class
        monkeypatch.setattr(DiT, "drop_classes", lambda self, labels, u: torch.full_like(
            labels, self.num_classes))
    else:  # Adam's step made, the EMA left at the initial weights
        orig = state._update
        monkeypatch.setattr(state, "_update", lambda st, loss, ema_rate: orig(st, loss, None))
    result = _run()
    assert result["correct"] is False
    if fault == "ema_skipped":
        assert result["checks"]["train_ema_gap"]["value"] == 1.0


def test_the_sound_program_is_correct_and_the_controls_are_wired():
    """At a size the CPU holds, float32 on both sides, the program reads
    far below every limit and each control reads each compared number far
    above it (the limits come from the card, bf16 against float32, at the
    cell's own size).  The EMA's limit sits nearer: on the card its change
    after one update reads 100 times closer than the weights' change after
    two, which the key bias's noise widens, where here both read the same
    (3e-6)."""
    sound = _run()
    assert sound["correct"] is True
    far = {"train_ema_gap": 1e-2}
    assert all(c["value"] < far.get(k, 1e-4) * c["limit"] for k, c in sound["checks"].items())
    for control in ("reference_fp8", "fault_half_batch"):
        low = _run(control=control)["checks"]
        assert max(c["value"] / max(sound["checks"][k]["value"], 1e-12)
                   for k, c in low.items()) > 100


def test_adaln_backward_bytes_by_hand():
    """DiT-XL/2 at batch 32, 256 tokens of 1,152 (E = 9,437,184 elements,
    bf16 ``h``, ``y`` and modulations): the gated launch with ``∂x'`` reads
    x' 4E, ∂h 2E, y 2E, ∂x' 4E and writes ∂x 4E, ∂y 2E, and reads gate and
    scale and writes ∂gate, ∂shift, ∂scale ([32, 1152] bf16 each):
    170,237,952 B, 50.82 µs at 3.35 TB/s; a step's 57 launches 9.59 GB (2.863 ms)."""
    e, m = 8192 * 1152, 32 * 1152 * 2
    assert adaln_backward_bytes(32, 256, 1152, True, True) == 18 * e + 5 * m == 170_237_952
    assert adaln_backward_bytes(32, 256, 1152, True, False) == 14 * e + 5 * m
    assert adaln_backward_bytes(32, 256, 1152, False, False) == 10 * e + 3 * m
    step = dit_step_backward_bytes(28, 32, 256, 1152)
    assert step == (10 * e + 3 * m) + 55 * (18 * e + 5 * m) + (14 * e + 5 * m) == 9_590_169_600
    assert round(170_237_952 / 3.35e12 * 1e6, 2) == 50.82


# Kernel names of a traced DiT-XL/2 epoch-lane step on the H100 (NVIDIA H100 80GB
# HBM3, 700.00 W; torch 2.11.0+cu128): the optimizer's and some of the step's others.
RECORDED = [
    ('void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace)::TensorListMetadata<2>, at::native::(anonymous namespace)::TernaryOpScalarFunctor<float, 2, 2, 0>, at::native::LerpFunctor<float>, float>(at::native::(anonymous namespace)::TensorListMetadata<2>, at::native::(anonymous namespace)::TernaryOpScalarFunctor<float, 2, 2, 0>, at::native::LerpFunctor<float>, float)',
     True),
    ('void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace)::TensorListMetadata<2>, at::native::(anonymous namespace)::BinaryOpListAlphaFunctor<float, 2, 2, 0>, std::plus<float>, float>(at::native::(anonymous namespace)::TensorListMetadata<2>, at::native::(anonymous namespace)::BinaryOpListAlphaFunctor<float, 2, 2, 0>, std::plus<float>, float)',
     True),
    ('void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace)::TensorListMetadata<1>, at::native::(anonymous namespace)::BinaryOpScalarFunctor<float, 1, 1, 0>, std::multiplies<float>, float>(at::native::(anonymous namespace)::TensorListMetadata<1>, at::native::(anonymous namespace)::BinaryOpScalarFunctor<float, 1, 1, 0>, std::multiplies<float>, float)',
     True),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, float, at::native::binary_internal::DivFunctor<float> > >(at::TensorIteratorBase&, at::native::BinaryFunctor<float, float, float, at::native::binary_internal::DivFunctor<float> > const&)::{lambda(int)#1}>(int, at::native::gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, float, at::native::binary_internal::DivFunctor<float> > >(at::TensorIteratorBase&, at::native::BinaryFunctor<float, float, float, at::native::binary_internal::DivFunctor<float> > const&)::{lambda(int)#1})',
     True),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)',
     True),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, float, float, at::native::binary_internal::DivFunctor<float> >, std::array<char*, 3ul> >(int, at::native::BinaryFunctor<float, float, float, at::native::binary_internal::DivFunctor<float> >, std::array<char*, 3ul>)',
     False),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::FillFunctor<long>, std::array<char*, 1ul> >(int, at::native::FillFunctor<long>, std::array<char*, 1ul>)',
     False),
    ('adaln_backward_kernel',
     False),
    ('adaln_kernel',
     False),
    ('nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN',
     False),
    ('cudnn_generated_fort_native_sdpa_sm90_flash_bprop_wgmma_f16_knob_26_64x64x128_1x4x1_cga1x1x1_kernel0_0',
     False),
    ('void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, 2ul> >(int, at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, 2ul>)',
     False),
    ('void at::native::reduce_kernel<128, 4, at::native::ReduceOp<c10::BFloat16, at::native::func_wrapper_t<c10::BFloat16, at::native::sum_functor<c10::BFloat16, float, c10::BFloat16>::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, c10::BFloat16, 4, 8> >(at::native::ReduceOp<c10::BFloat16, at::native::func_wrapper_t<c10::BFloat16, at::native::sum_functor<c10::BFloat16, float, c10::BFloat16>::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, c10::BFloat16, 4, 8>)',
     False),
    ('void at::native::vectorized_elementwise_kernel<8, at::native::GeluBackwardCUDAKernelImpl(at::TensorIteratorBase&, at::native::GeluType)::{lambda()#1}::operator()() const::{lambda()#4}::operator()() const::{lambda(c10::BFloat16, c10::BFloat16)#1}, std::array<char*, 3ul> >(int, at::native::GeluBackwardCUDAKernelImpl(at::TensorIteratorBase&, at::native::GeluType)::{lambda()#1}::operator()() const::{lambda()#4}::operator()() const::{lambda(c10::BFloat16, c10::BFloat16)#1}, std::array<char*, 3ul>)',
     False),
]


@pytest.mark.parametrize("name, optimizer", RECORDED, ids=range(len(RECORDED)))
def test_optimizer_share_names_its_kernels(name, optimizer):
    assert is_optimizer(name) is optimizer


def test_program_leaves_follow_the_draw_order():
    """The DiT's parameters come in the reference's ``param_spec`` order,
    the order the Adam hook reads them in."""
    from distillation_trajectories_torch.models.dit import DiT

    model = DiT(input_size=8, in_channels=4, depth=2, hidden_size=64, num_heads=4)
    s = ref_dit.sizes(2, 64, 4, input_size=8)
    assert [n for n, _ in model.named_parameters()] == [n for n, _, _ in ref_dit.param_spec(s)]


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["reference_fp8", "fault_half_batch"])
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 3])
def test_controls_fail_on_the_card(card, control, seed):
    cell = harness.find_cell(harness.manifest(), CELL)
    assert harness.run_cell(cell, seed, 1.0, False, card, control=control)["correct"] is False


def test_step_bytes_count_each_seam_once():
    """A DiT step's launches: one ungated, 2·depth − 1 gated with ∂x', one
    gated without (the last block's end, whose x' goes nowhere)."""
    depth = 3
    one = lambda g, d: adaln_backward_bytes(2, 4, 16, g, d)
    assert dit_step_backward_bytes(depth, 2, 4, 16) == one(False, False) + 5 * one(True, True) \
        + one(True, False)
    assert np.isclose(dit_step_backward_bytes(depth, 2, 4, 16),
                      2 * 4 * 16 * (10 + 5 * 18 + 14) + 2 * 16 * 2 * (3 + 5 * 5 + 5))
