"""K5: forward flash attention with an fp32 online softmax.

The port of ``src/repro/kernels/flash_attention.py:flash_attention`` (the
Pallas TPU kernel, body ``_kernel``).  ``q (BH, Sq, dh)``, ``k (BH, Sk, dh)``
and ``v (BH, Sk, dv)``, in f32 or bf16 and computed in f32, give
``softmax((q k^T) * scale) v`` as ``(BH, Sq, dv)`` in ``q.dtype``, with
``scale`` defaulting to ``dh ** -0.5``.  With ``causal``, key ``col`` is seen
by query ``row`` only where ``col <= row`` (positional, top-left aligned;
masked scores are -1e30).  Forward only, as the Pallas kernel is.

``flash_attention`` picks its implementation by device, dtype and head
widths alone (``_route``), never by trying one and falling back:

- CPU tensors run ``flash_attention_plain``, the Pallas body written out
  over ``(q_chunk, k_chunk)`` chunks in plain PyTorch;
- CUDA bf16 tensors with ``dh`` and ``dv`` multiples of 8 in 8..256 launch
  the tensor-core kernel (``csrc/flash_attention_wgmma.cu``: wgmma + TMA,
  P carried as bf16 hi + lo);
- every other CUDA call (f32, or bf16 outside those widths) launches the
  CUDA-core kernel (``csrc/flash_attention.cu``: fp32 FMA), which the JAX
  tests' f32 tolerance of 2e-5 needs.

On a CUDA tensor the chosen kernel runs or the call raises (the tensor-core
kernel's TMA maps need 16-byte aligned data: a view that starts between
16-byte boundaries raises).  ``q_chunk`` / ``k_chunk`` fix which lengths
are accepted (``Sq % min(q_chunk, Sq) == 0``, the same for ``Sk``), as in
the JAX package; the CUDA kernels tile by their own sizes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1.0e30   # masked scores (flash_attention.py:27)
MAX_DV = 256        # csrc/flash_attention.cu: kMaxDV
WGMMA_MAX_D = 256   # csrc/flash_attention_wgmma.cu: kMaxD
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches made by flash_attention, one key per CUDA route (reset by callers)
LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0}
ROUTE_KERNEL = {"cuda_core": "flash_attention", "wgmma": "flash_attention_wgmma"}


def _chunks(q, k, v, q_chunk, k_chunk):
    """Check shapes and devices; ``(qc, kc)`` as the JAX package clamps them."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be 3-D (BH, S, d), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, dh = q.shape
    if k.shape[0] != bh or v.shape[0] != bh or k.shape[2] != dh or v.shape[1] != k.shape[1]:
        raise ValueError(
            f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
            " (need k (BH, Sk, dh), v (BH, Sk, dv))"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must be on one device, got {q.device}, {k.device}, {v.device}")
    sk = k.shape[1]
    qc = min(q_chunk, sq)
    kc = min(k_chunk, sk)
    if sq % qc or sk % kc:
        raise ValueError(f"seq lens ({sq},{sk}) must divide chunks ({qc},{kc})")
    return qc, kc


def flash_attention_plain(q, k, v, *, causal=True, q_chunk=512, k_chunk=512, scale=None):
    """Plain PyTorch version of K5: the Pallas body over ``(qc, kc)`` chunks."""
    qc, kc = _chunks(q, k, v, q_chunk, k_chunk)
    bh, sq, dh = q.shape
    sk, dv = v.shape[1], v.shape[2]
    if scale is None:
        scale = float(dh) ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    for q_start in range(0, sq, qc):
        qi = qf[:, q_start:q_start + qc]
        m = torch.full((bh, qc, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((bh, qc, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bh, qc, dv), dtype=torch.float32, device=q.device)
        for k_start in range(0, sk, kc):
            if causal and k_start > q_start + qc - 1:  # wholly above the diagonal
                continue
            s = torch.bmm(qi, kf[:, k_start:k_start + kc].transpose(1, 2)) * scale
            if causal:
                rows = q_start + torch.arange(qc, device=q.device)[:, None]
                cols = k_start + torch.arange(kc, device=q.device)[None, :]
                s = torch.where(cols <= rows, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=2, keepdim=True)
            acc = acc * corr + torch.bmm(p, vf[:, k_start:k_start + kc])
            m = m_new
        out[:, q_start:q_start + qc] = (acc / l.clamp_min(1e-37)).to(q.dtype)
    return out


def _route(q, v):
    """``"plain"`` for a CPU ``q``; else ``"wgmma"`` for bf16 with ``dh`` and
    ``dv`` multiples of 8 in 8..256 (TMA needs 16-byte rows), else
    ``"cuda_core"``.  Reads only the device, the dtype and the widths."""
    if q.device.type == "cpu":
        return "plain"
    dh, dv = q.shape[-1], v.shape[-1]
    if q.dtype == torch.bfloat16 and all(d % 8 == 0 and 8 <= d <= WGMMA_MAX_D for d in (dh, dv)):
        return "wgmma"
    return "cuda_core"


def _launch(route, q, k, v, causal, scale):
    """Launch the CUDA kernel of ``route`` on tensors ``flash_attention`` has
    checked, and count the launch under ``ROUTE_KERNEL[route]``."""
    out = torch.empty((q.shape[0], q.shape[1], v.shape[2]), dtype=q.dtype, device=q.device)
    launch = _build.launch_flash_attention_wgmma if route == "wgmma" else _build.launch_flash_attention
    launch(q, k, v, out, scale, causal)
    LAUNCHES[ROUTE_KERNEL[route]] += 1
    return out


def flash_attention(q, k, v, *, causal=True, q_chunk=512, k_chunk=512, scale=None):
    """Forward attention (K5): ``(BH, Sq, dh) x (BH, Sk, dh) x (BH, Sk, dv) -> (BH, Sq, dv)``.

    A CUDA ``q`` launches a CUDA kernel (contiguous f32 or bf16 tensors of
    one type, ``dv <= 256``, any ``dh``; ``_route`` picks the kernel); a CPU
    ``q`` runs the plain version.  Raises ``ValueError`` when ``Sq`` or
    ``Sk`` does not divide its chunk.
    """
    _chunks(q, k, v, q_chunk, k_chunk)
    route = _route(q, v)
    if route == "plain":
        return flash_attention_plain(q, k, v, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not {q.device}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16 q, k, v of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous q, k, v")
    dh, dv = q.shape[2], v.shape[2]
    if not 1 <= dv <= MAX_DV:
        raise ValueError(f"the CUDA kernel takes value widths 1..{MAX_DV}, got dv={dv}")
    if scale is None:
        scale = float(dh) ** -0.5
    return _launch(route, q, k, v, causal, scale)
