"""What a kernel's weights packed once at the pipeline's build follow: K1's
and K6's stage packings (`models/bigvgan.py`) and K7's stacked experts
(`models/moe_llm.py`) are made again only when this key changes."""

from __future__ import annotations


def weights_version(tensors) -> tuple:
    """Each tensor's storage, dtype and version (a module made inside
    `torch.inference_mode()` holds inference tensors, which keep no
    version: their key follows the storage)."""
    return tuple((t.data_ptr(), t.dtype, None if t.is_inference() else t._version)
                 for t in tensors)
