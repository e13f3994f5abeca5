"""The four assigned input shapes and each architecture's applicability.

A copy of ``repro.launch.shapes`` (framework-free), kept in the port so
that the port imports nothing of the JAX package.  Decode shapes run ONE
token against a ``seq_len`` cache, not a train step.  ``long_500k`` needs
sub-quadratic serving; the full-attention archs and whisper skip it, and
the dry-run writes the skip and its reason down.
"""

from __future__ import annotations

from typing import NamedTuple


class InputShape(NamedTuple):
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def applicability(cfg, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason)."""
    if shape.name == "long_500k":
        if cfg.is_encoder_decoder:
            return False, ("skip: encoder-decoder (whisper) has no 500k "
                           "target-side decode; max target length << 500k")
        if not cfg.supports_long_context():
            return False, ("skip: pure full-attention arch -- long_500k "
                           "requires sub-quadratic serving (SSM/hybrid/"
                           "SWA); see gemma-7b-swa for the dense variant")
        return True, "ok: sub-quadratic (recurrent state / sliding window)"
    if cfg.is_encoder_decoder and shape.name in ("prefill_32k",
                                                 "decode_32k"):
        return True, ("ok (structural): beyond whisper's native 448 "
                      "positions; sinusoidal positions extend")
    return True, "ok"
