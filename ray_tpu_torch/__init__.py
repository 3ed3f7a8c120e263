"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's accelerator path.

The flagship Llama model, its two attention kernels (flash prefill and
paged decode, hand-written CUDA for Hopper under ``csrc/``) and the
continuous-batching LLM engine.  The package imports ``torch`` and
numpy and nothing of ``ray_tpu``; where it needs a pure-Python helper
from there it keeps its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:
with no GPU and no explicit ``"cpu"`` they raise instead of quietly
running on the CPU.  On a CPU tensor each kernel wrapper computes its
plain PyTorch version; on a CUDA tensor it launches the kernel or raises.
"""

from ray_tpu_torch._private.device import resolve_device

__all__ = ["resolve_device"]
