"""Where a flash_attention call goes, and why the tensor-core kernel
carries P as two bf16 halves. Runs on the CPU and imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_route.py

``route`` is a pure function of the tensors, so it is tested here on CPU
tensors. The wgmma kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py); its P arithmetic is emulated here in
f32: the reference computes ``p @ v`` in f32, and the port's bf16 check
allows one bf16 quantum of that result plus 2e-5.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import route
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

BF16, F32 = torch.bfloat16, torch.float32
NEG = -1e30


def _qkv(b, t, s, h, hkv, hd, dtype):
    return [torch.zeros(shape, dtype=dtype)
            for shape in ((b, t, h, hd), (b, s, hkv, hd), (b, s, hkv, hd))]


def _misaligned(shape):
    """A contiguous bf16 tensor whose base is 2 bytes off a 16-byte
    boundary."""
    buf = torch.zeros(math.prod(shape) + 8, dtype=BF16)
    off = 1 if buf.data_ptr() % 16 == 0 else 0
    return buf[off:off + math.prod(shape)].view(shape)


@pytest.mark.parametrize("case,want", [
    (dict(b=2, t=1024, s=1024, h=24, hkv=8, hd=128, dtype=BF16), "wgmma"),
    (dict(b=2, t=1024, s=1024, h=32, hkv=8, hd=64, dtype=BF16), "wgmma"),
    (dict(b=1, t=77, s=131, h=4, hkv=4, hd=64, dtype=BF16), "wgmma"),
    (dict(b=2, t=64, s=64, h=6, hkv=2, hd=128, dtype=F32), "simt"),
    (dict(b=2, t=64, s=64, h=4, hkv=2, hd=32, dtype=BF16), "simt"),
    (dict(b=1, t=64, s=64, h=4, hkv=2, hd=96, dtype=BF16), "simt"),
    (dict(b=2, t=1, s=1, h=32768, hkv=1, hd=64, dtype=BF16), "simt"),
    (dict(b=1, t=0, s=8, h=2, hkv=1, hd=64, dtype=BF16), "simt"),
    (dict(b=1, t=8, s=0, h=2, hkv=1, hd=64, dtype=BF16), "simt"),
], ids=["train_hd128", "granite_hd64", "ragged_hd64", "f32", "hd32", "hd96",
        "b_times_h_65536", "empty_t", "empty_s"])
def test_route(case, want):
    c = dict(case)
    assert route(*_qkv(**c)) == want


def test_route_refuses_what_tma_cannot_read():
    q, k, v = _qkv(1, 16, 16, 4, 2, 64, BF16)
    assert route(q, k, v) == "wgmma"
    assert route(_misaligned(tuple(q.shape)), k, v) == "simt"
    assert route(q, k.transpose(1, 2).contiguous().transpose(1, 2), v) == \
        "simt"                                   # not contiguous
    assert route(q, k.float(), v) == "simt"


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(BF16) for shape in ((1, 40, 4, 64), (1, 40, 2, 64),
                                       (1, 40, 2, 64)))
    before = dict(flash_attention.route_launches), flash_attention.launches
    out = flash_attention(q, k, v, window=9)
    assert torch.equal(out, flash_attention_ref(q, k, v, window=9))
    assert (dict(flash_attention.route_launches),
            flash_attention.launches) == before


def _emulate(q, k, v, p_bf16):
    """The wgmma kernel's arithmetic in f32, causal: 64-key tiles, scores
    scaled then masked to NEG, the online softmax with its zero guards,
    acc = acc * corr + P V with P given to the product by ``p_bf16(p)``
    as a list of bf16-valued f32 terms, then bf16(acc / max(l, 1e-30))."""
    b, t, h, hd = q.shape
    s, n_rep = k.shape[1], h // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty((b, t, h, hd), dtype=BF16)
    qpos = torch.arange(t)[:, None]
    for bi in range(b):
        for hi in range(h):
            qh, kh, vh = (q[bi, :, hi], k[bi, :, hi // n_rep],
                          v[bi, :, hi // n_rep])
            m = torch.full((t,), NEG)
            l = torch.zeros(t)
            acc = torch.zeros((t, hd))
            for k0 in range(0, s, 64):
                sc = (qh @ kh[k0:k0 + 64].T) * scale
                kpos = k0 + torch.arange(sc.shape[1])[None, :]
                sc = torch.where(kpos <= qpos, sc, torch.tensor(NEG))
                m_new = torch.maximum(m, sc.max(dim=1).values)
                p = torch.where(sc > NEG / 2, torch.exp(sc - m_new[:, None]),
                                torch.zeros(()))
                corr = torch.where(m > NEG / 2, torch.exp(m - m_new),
                                   torch.zeros(()))
                l = l * corr + p.sum(dim=1)
                acc = acc * corr[:, None]
                for part in p_bf16(p):
                    acc = acc + part @ vh[k0:k0 + 64]
                m = m_new
            lsafe = torch.clamp(l, min=1e-30)[:, None]
            out[bi, :, hi] = (acc / lsafe).to(BF16)
    return out


def _hi_lo(p):
    hi = p.to(BF16).float()
    return [hi, (p - hi).to(BF16).float()]


def _outside_bf16_check(out, ref):
    """Outputs more than one bf16 quantum of the f32 result (+ 2e-5) away:
    the port's bf16 rule for flash_attention."""
    _, e = torch.frexp(ref)
    quantum = torch.ldexp(torch.ones_like(ref), e - 8)
    return int(((out.float() - ref).abs() > quantum + 2e-5).sum())


def test_p_split_hi_lo_keeps_the_bf16_check_and_rounding_once_does_not():
    """At (B 1, T = S 256, 6 / 2 heads, hd 128), causal: P carried as
    bf16 hi + lo (p to about 2^-17) leaves every output within one bf16
    quantum of the f32 reference plus 2e-5; P rounded once to bf16, as a
    single bf16 P V product would take it, puts about 14% of them
    outside. So the wgmma kernel pays for a second P V product."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(BF16).float() for shape in ((1, 256, 6, 128),
                                               (1, 256, 2, 128),
                                               (1, 256, 2, 128)))
    ref = flash_attention_ref(q, k, v)
    n = ref.numel()
    split = _emulate(q, k, v, _hi_lo)
    once = _emulate(q, k, v, lambda p: [p.to(BF16).float()])
    assert _outside_bf16_check(split, ref) == 0
    assert _outside_bf16_check(once, ref) > 0.10 * n


def test_p_hi_lo_holds_p_to_2_pow_minus_17():
    p = torch.from_numpy(np.random.default_rng(12).random(100_000)
                         .astype(np.float32))
    hi, lo = _hi_lo(p)
    assert torch.all((hi + lo - p).abs() <= 2.0 ** -17 * p)
