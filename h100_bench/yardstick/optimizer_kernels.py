"""The optimizer's kernels by the names the device trace gives them on the
H100 (torch 2.11, CUDA 12.8), in a train step of the epoch lane:

* ``torch.optim.Adam``'s foreach update (capturable) and the trainer's EMA
  (``torch._foreach_mul_``, ``_foreach_add_``) launch PyTorch's
  multi-tensor apply kernel, which nothing else of a train step launches;
* capturable Adam divides each leaf's ``sqrt(v)`` by that leaf's 0-d bias
  correction, which the foreach kernel cannot batch (the shapes differ), so
  PyTorch runs it leaf by leaf through its broadcasting division kernel
  (``elementwise_kernel`` of ``BinaryFunctor<float, float, float,
  DivFunctor<float>>``; two a leaf a step); the step's other float
  divisions take the vectorised kernel of another name;
* ``Optimizer.zero_grad(set_to_none=False)`` without foreach fills each
  gradient with zeros (``FillFunctor<float>``, one a leaf; a DiT-XL/2
  step's 305 such fills hold its 291 leaves' and 14 small ones of the step
  itself).

A fused Adam would launch kernels of its own names, listed too."""

OPTIMIZER = (
    "multi_tensor_apply_kernel",
    "gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, float, "
    "at::native::binary_internal::DivFunctor<float> >",
    "vectorized_elementwise_kernel<4, at::native::FillFunctor<float>",
    "fused_adam",
    "FusedAdam",
)


def is_optimizer(name: str) -> bool:
    return any(k in name for k in OPTIMIZER)
