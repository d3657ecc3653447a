"""Input stand-ins per (architecture x shape) cell, PyTorch port of
``repro.launch.specs``: ``meta`` tensors of the reference's shapes and
dtypes, the counterpart of ``jax.ShapeDtypeStruct``.

The assigned LM shape set:
    train_4k      seq 4096,    global_batch 256   (train_step)
    prefill_32k   seq 32768,   global_batch 32    (prefill)
    decode_32k    context 32k, global_batch 128   (serve_step)
    long_500k     context 512k, global_batch 1    (serve_step, sub-quadratic
                                                   archs only)

Modality frontends are stubs (assignment): audio frames / vision patches are
precomputed embeddings in the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

SHAPES = {
    "train_4k": dict(kind="train", seq=4_096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768, batch=32),
    "decode_32k": dict(kind="decode", seq=32_768, batch=128),
    "long_500k": dict(kind="decode", seq=524_288, batch=1),
}

AUDIO_FRAMES = 1024  # stub speech-encoder output length (seamless)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: str
    kind: str                     # train | prefill | decode
    batch: Dict[str, Any]         # meta tensors
    seq: int
    global_batch: int
    skip_reason: Optional[str] = None


def applicable(cfg, shape_name: str) -> Optional[str]:
    """None if the cell runs; else the skip reason (recorded in DESIGN.md)."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return (
            "full-attention arch: 524k dense decode is quadratic full "
            "attention; skipped per assignment (DESIGN.md #3)"
        )
    return None


def input_specs(cfg, shape_name: str, seq: Optional[int] = None) -> CellSpec:
    """Meta stand-ins for every model input of this cell; ``seq`` replaces
    the shape's sequence length (a shortened cell)."""
    info = SHAPES[shape_name]
    kind, batch = info["kind"], info["batch"]
    seq = seq or info["seq"]
    i32 = torch.int32
    b: Dict[str, Any] = {}
    if kind == "train":
        b["tokens"] = _meta((batch, seq), i32)
        b["labels"] = _meta((batch, seq), i32)
    elif kind == "prefill":
        b["tokens"] = _meta((batch, seq), i32)
        b["labels"] = _meta((batch, seq), i32)  # unused by prefill
    else:  # decode
        b["token"] = _meta((batch,), i32)
    if cfg.encoder_groups is not None and kind != "decode":
        b["frames"] = _meta((batch, AUDIO_FRAMES, cfg.enc_input_dim), torch.float32)
    if cfg.vision_tokens and kind != "decode":
        b["patches"] = _meta((batch, cfg.vision_tokens, cfg.vision_dim), torch.float32)
    return CellSpec(
        arch=cfg.name, shape=shape_name, kind=kind, batch=b, seq=seq,
        global_batch=batch, skip_reason=applicable(cfg, shape_name),
    )


def memory_spec(cfg, batch: int):
    """Decode-time cross-attention memory (enc-dec / VLM), already projected."""
    adt = getattr(torch, cfg.activation_dtype)
    if cfg.encoder_groups is not None:
        return _meta((batch, AUDIO_FRAMES, cfg.d_model), adt)
    if cfg.vision_tokens:
        return _meta((batch, cfg.vision_tokens, cfg.d_model), adt)
    return None
