"""``moe_experts_roofline`` (%): the routed expert products' least time
over their measured device time, in the traced window.

The least time is the sum, over the window's batches and the model's
layers, of ``roofline/moe_seqrec.experts_layer``'s bound: the real
tokens' k pairs at 6·d·f FLOPs each (the two grouped products: gate and
up together, then down), against the bytes of every expert's weights
read once and each pair's rows once. The measured time is the device
time of the grouped GEMM kernels that ``torch._grouped_mm`` launches on
sm_90, which the card's trace names by their CUTLASS template
(``cutlass::device_kernel<at::cuda::detail::enable_3x_kernel_for_sm9x<
cutlass::gemm::kernel::GemmUniversal<cutlass::gemm::GroupProblemShape
...>>>``, mangled, beginning ``_ZN7cutlass13device_kernel``): every
kernel whose name holds "cutlass" and "Group". Nothing to read (no
trace, or no such kernel ran): no value.
"""

from benchmark.roofline.moe_seqrec import _layers, experts_layer, least_s


def _is_expert_product(name: str) -> bool:
    return "cutlass" in name and "Group" in name


def read(outcome):
    if outcome.trace is None:
        return None
    measured = outcome.trace.device_seconds(_is_expert_product)
    if measured <= 0:
        return None
    cfg = outcome.config
    least = sum(least_s(experts_layer(cfg, lengths), outcome.peaks)
                for lengths in outcome.facts["batch_lengths"]) * len(_layers(cfg))
    return 100.0 * least / measured
