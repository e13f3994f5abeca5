"""Variant configs beyond the assigned list.

gemma-7b-swa: gemma-7b with a 4096 sliding window -- the explicit
dense->SWA path that licenses the long_500k shape for a dense arch
(DESIGN.md shape-applicability)."""

import dataclasses

from repro_torch.configs.base import register
from repro_torch.configs.gemma_7b import gemma_7b


@register
def gemma_7b_swa():
    return dataclasses.replace(gemma_7b(), name="gemma-7b-swa",
                               window=4096)
