"""Published peaks of the cards the benchmark runs on.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 989 TFLOP/s in bf16 and fp16, 67 TFLOP/s in float32
outside the tensor cores, 3.35 TB/s of HBM3. Every ``mfu`` metric is a
share of the bf16 dense peak, whatever precision the program runs in, so
that a change of precision cannot lift a share past 100%.
"""

from __future__ import annotations

#: (substring of ``torch.cuda.get_device_name()`` lower-cased, peaks)
PEAKS: tuple[tuple[str, dict[str, float]], ...] = (
    ("h100", {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12}),
)

#: the card the benchmark's cells are sized for; also the peaks that CPU
#: tests of the arithmetic use
DEFAULT_KIND = "NVIDIA H100 80GB HBM3"


def peaks_for(kind: str) -> dict[str, float]:
    """The peaks of the card named ``kind``; a card not in the table
    raises, since a share of an unknown peak means nothing."""
    name = kind.lower()
    for needle, peaks in PEAKS:
        if needle in name:
            return dict(peaks)
    raise KeyError(f"no published peaks for {kind!r}; add the card to benchmark/roofline/peaks.py")
