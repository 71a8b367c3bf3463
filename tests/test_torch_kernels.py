"""The port's plain kernel twins against the JAX package's Pallas kernels
(interpret mode) and XLA paths, on the CPU.

Each kernel of polgen_rvc_tpu_torch has a plain PyTorch twin that the CPU
runs and that the CUDA kernel is held to on the card. Here the twin meets
the TPU kernel on identical numpy inputs:
  - with ``operand_dtype=torch.bfloat16`` the twin rounds the same operands
    to bf16 as the Pallas kernel does, so only fp32 summation order differs;
  - with no operand rounding it meets the JAX XLA path (plain fp32).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from polgen_rvc_tpu.models.nsf import resblock
from polgen_rvc_tpu.models.rmvpe import _block_chain
from polgen_rvc_tpu.models.synthesizer import relative_attention as jax_relattn
from polgen_rvc_tpu.ops.conv import conv_transpose1d as jax_convt
from polgen_rvc_tpu.ops.flash_relattn import relative_attention_flash
from polgen_rvc_tpu.ops.pallas_convtranspose import conv_transpose1d_pallas
from polgen_rvc_tpu.ops.pallas_resblock import (
    fused_resblock_group as jax_group,
    fused_resblock_group_folded as jax_group_folded,
)
from polgen_rvc_tpu.ops.pallas_unet2d import fused_convblock_chain_folded
from polgen_rvc_tpu_torch.convert.params import params_to_torch
from polgen_rvc_tpu_torch.models.synthesizer import relative_attention
from polgen_rvc_tpu_torch.ops.band_attention import band_attention_plain
from polgen_rvc_tpu_torch.ops.conv_transpose import (
    conv_transpose1d, conv_transpose1d_plain, pack_phase_taps, phase_taps,
)
from polgen_rvc_tpu_torch.ops.resblock_group import (
    fused_resblock_group, pack_resblock_weights, resblock_group_plain,
    resblock_pair_plain,
)
from polgen_rvc_tpu_torch.ops.unet_chain import (
    convblock_chain, convblock_chain_plain, pack_taps_3x3, pack_unet_weights,
    padded_channels, unet_conv3x3_plain,
)

KS, DS = (3, 7, 11), ((1, 3, 5),) * 3


def _resblock_params(rng, c):
    out = []
    for k, dils in zip(KS, DS):
        p = {"convs1": [], "convs2": []}
        for _ in dils:
            for key in ("convs1", "convs2"):
                p[key].append({
                    "w": (rng.standard_normal((c, c, k)) / np.sqrt(c * k)).astype(np.float32),
                    "b": (rng.standard_normal(c) * 0.02).astype(np.float32),
                })
        out.append(p)
    return out


def params_to_jax(tree):
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_jax(v) for v in tree]
    return jnp.asarray(tree)


@pytest.mark.parametrize("c,t,fold", [(32, 1000, 0), (64, 640, 0), (32, 1024, 4)])
def test_resblock_group_matches_pallas_and_xla(c, t, fold):
    rng = np.random.default_rng(c + t)
    params = _resblock_params(rng, c)
    x = (rng.standard_normal((2, c, t)) * 0.3).astype(np.float32)
    tp = params_to_torch(params)
    xt = torch.from_numpy(x)

    # bf16 operands on both sides; fp32 summation order differs, and an
    # intermediate that lands near a bf16 rounding boundary can round one
    # ulp (2^-8 relative) apart before the next conv: 5e-3 absolute on
    # outputs of magnitude ~1.5
    if fold:
        ref = jax_group_folded(jnp.asarray(x), params, kernel_sizes=KS,
                               dilations=DS, fold=fold, time_tile=64,
                               interpret=True)
    else:
        ref = jax_group(jnp.asarray(x), params, kernel_sizes=KS, dilations=DS,
                        time_tile=256, interpret=True)
    got = resblock_group_plain(xt, tp, KS, DS, operand_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=5e-3)

    # fp32 against the XLA path: same arithmetic, order only (1e-4)
    xla = None
    for r, (k, dils) in enumerate(zip(KS, DS)):
        y = resblock(jnp.asarray(x), params[r], kernel_size=k, dilations=dils)
        xla = y if xla is None else xla + y
    xla = np.asarray(xla) / len(KS)
    cpu = fused_resblock_group(xt, tp, KS, DS)  # the wrapper, on a CPU tensor
    np.testing.assert_allclose(cpu.numpy(), xla, rtol=1e-4, atol=1e-4)


def _group_from_pairs(x, params, ks, ds, operand_dtype):
    """The group as the CUDA wrapper launches it: one resblock_pair_plain
    per conv pair, the fp32 residual stream and running sum between them."""
    acc, n_res = None, len(ks)
    for r, (p, k, dils) in enumerate(zip(params, ks, ds)):
        src = x
        for i, d in enumerate(dils):
            last = i == len(dils) - 1
            v = resblock_pair_plain(src, p["convs1"][i], p["convs2"][i], k, d,
                                    acc=acc if last else None,
                                    last=last and r == n_res - 1, n_res=n_res,
                                    out_dtype=x.dtype, operand_dtype=operand_dtype)
            if last:
                acc = v
            else:
                src = v
    return acc


@pytest.mark.parametrize("operand_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("c,t", [(32, 5), (32, 37), (32, 300), (64, 5), (64, 37),
                                 (64, 129)])
def test_resblock_pair_twin_composes_to_the_group(c, t, operand_dtype):
    """Nine pair twins, in the wrapper's order, give resblock_group_plain bit
    for bit. T = 5 and 37 are shorter than the deepest halo (k = 11, d = 5:
    25 + 5 samples a side), where zeroing h outside [0, T) decides the
    result."""
    rng = np.random.default_rng(c * 7 + t)
    params = params_to_torch(_resblock_params(rng, c))
    x = torch.from_numpy((rng.standard_normal((2, c, t)) * 0.3).astype(np.float32))
    for xin in (x, x.to(torch.bfloat16)):
        ref = resblock_group_plain(xin, params, KS, DS, operand_dtype=operand_dtype)
        got = _group_from_pairs(xin, params, KS, DS, operand_dtype)
        assert got.dtype == xin.dtype and torch.equal(got, ref)


def test_resblock_pair_twin_epilogues():
    """One pair's three epilogues: the stream (v), the running sum (acc + v)
    and the group's mean in the output dtype; h is zero outside [0, T)."""
    rng = np.random.default_rng(3)
    c, t, k, d = 32, 9, 11, 5
    p = params_to_torch(_resblock_params(rng, c))[2]
    c1, c2 = p["convs1"][2], p["convs2"][2]
    x = torch.from_numpy((rng.standard_normal((1, c, t)) * 0.3).astype(np.float32))
    acc = torch.from_numpy(rng.standard_normal((1, c, t)).astype(np.float32))
    h = F.leaky_relu(F.conv1d(F.leaky_relu(x, 0.1), c1["w"], c1["b"],
                              padding=d * (k - 1) // 2, dilation=d), 0.1)
    v = x + F.conv1d(h, c2["w"], c2["b"], padding=(k - 1) // 2)
    assert torch.equal(resblock_pair_plain(x, c1, c2, k, d), v)
    assert torch.equal(resblock_pair_plain(x, c1, c2, k, d, acc=acc), acc + v)
    out = resblock_pair_plain(x, c1, c2, k, d, acc=acc, last=True, n_res=3,
                              out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ((acc + v) / 3).to(torch.bfloat16))


def test_resblock_group_bf16_input_matches_pallas():
    """x in bf16, as the decoder hands it over on the card: JAX's Pallas
    kernel (interpret mode) and the port's twin both return bf16. Tolerance:
    the fp32 cases' 5e-3 plus one bf16 rounding of the output (2^-8 |ref|)."""
    rng = np.random.default_rng(17)
    c, t = 32, 600
    params = _resblock_params(rng, c)
    x = (rng.standard_normal((2, c, t)) * 0.3).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = jax_group(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), params,
                    kernel_sizes=KS, dilations=DS, time_tile=256, interpret=True)
    got = _group_from_pairs(xb, params_to_torch(params), KS, DS, torch.bfloat16)
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref32)
    assert np.all(err <= 5e-3 + 2.0 ** -8 * np.abs(ref32)), float(err.max())


@pytest.mark.parametrize("k,u,c_in,c_out", [(24, 12, 64, 32), (20, 10, 32, 16),
                                            (4, 2, 32, 16)])
def test_conv_transpose_matches_pallas_and_xla(k, u, c_in, c_out):
    rng = np.random.default_rng(k)
    pad = (k - u) // 2
    x = (rng.standard_normal((2, c_in, 45)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((c_in, c_out, k)) / np.sqrt(c_in * k)).astype(np.float32)
    b = (rng.standard_normal(c_out) * 0.02).astype(np.float32)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))

    # identical bf16 operands: fp32 summation order only (1e-4 relative)
    ref = conv_transpose1d_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  stride=u, padding=pad, time_tile=16,
                                  interpret=True)
    got = conv_transpose1d_plain(xt, wt, bt, stride=u, padding=pad,
                                 operand_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)

    xla = jax_convt(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                    stride=u, padding=pad)
    got = conv_transpose1d_plain(xt, wt, bt, stride=u, padding=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=1e-4, atol=1e-5)

    # the CUDA kernel's weight layout, emulated phase by phase (fp32, order
    # only)
    emu = _phase_by_phase(xt, pack_phase_taps(wt, u, pad), bt, u, pad)
    np.testing.assert_allclose(emu.numpy(), np.asarray(xla), rtol=1e-4, atol=1e-5)


def _phase_by_phase(x, taps, b, u, pad):
    """y from the phase-packed taps as the CUDA kernel decomposes it: phase
    r sums, over its offsets d in phase_taps, the packed block times x
    shifted by d (zero outside [0, T)); the phases interleave at stride u.
    Phase r's blocks start where the kernel's loop puts them, and its
    offsets are the kernel's run floor((r - pad)/u) .. floor((r + pad)/u),
    within the staged halo -H..H."""
    bsz, _, t = x.shape
    halo = max(1, -(-pad // u))
    xp = F.pad(x.float(), (halo, halo))  # x[m + d] is xp[m + halo + d]
    y = torch.empty(bsz, taps.shape[1], t, u)
    blk = 0
    for r, ds in enumerate(phase_taps(u, pad)):
        assert blk == sum((rr + pad) // u - (rr - pad) // u + 1 for rr in range(r))
        assert ds == list(range((r - pad) // u, (r + pad) // u + 1))
        assert -halo <= ds[0] and ds[-1] <= halo
        acc = b[None, :, None].expand(bsz, -1, t)
        for d in ds:
            acc = acc + torch.einsum("oc,bct->bot", taps[blk].float(),
                                     xp[:, :, halo + d:halo + d + t])
            blk += 1
        y[..., r] = acc
    assert blk == taps.shape[0]
    return y.reshape(bsz, -1, t * u)


@pytest.mark.parametrize("k,u,c_in,c_out", [(24, 12, 64, 32), (16, 10, 32, 32),
                                            (4, 2, 32, 16), (16, 4, 32, 32),
                                            (8, 2, 32, 32)])
def test_phase_packed_taps_give_the_transposed_conv(k, u, c_in, c_out):
    """The layout the CUDA kernel reads: only the taps of each phase's
    offsets, no zero block, and phase by phase they give the transposed
    conv: 48 kHz's first stage (u = 12, k = 24), 40 kHz's second (u = 10,
    k = 16: phases 3..6 have one tap), u = 2, k = 4, and the halo-2
    geometries (padding > stride): v1 32 kHz's second stage (u = 4, k = 16,
    four taps a phase, offsets -2..2) and u = 2, k = 8, at narrow widths."""
    rng = np.random.default_rng(100 + k)
    pad = (k - u) // 2
    x = (rng.standard_normal((2, c_in, 37)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((c_in, c_out, k)) / np.sqrt(c_in * k)).astype(np.float32)
    b = (rng.standard_normal(c_out) * 0.02).astype(np.float32)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))

    n_taps = [len(ds) for ds in phase_taps(u, pad)]
    assert sum(n_taps) == k
    if (k, u) == (16, 10):
        assert n_taps == [2, 2, 2, 1, 1, 1, 1, 2, 2, 2]
    else:
        assert n_taps == [k // u] * u
    taps = pack_phase_taps(wt, u, pad)
    assert taps.shape == (k, c_out, c_in)
    assert bool((taps.abs().amax(dim=(1, 2)) > 0).all())  # no all-zero block

    # fp32: summation order only
    emu = _phase_by_phase(xt, taps, bt, u, pad)
    ref = conv_transpose1d_plain(xt, wt, bt, stride=u, padding=pad)
    np.testing.assert_allclose(emu.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)

    # bf16-rounded operands both sides: fp32 summation order only (1e-4).
    # Against the Pallas kernel where padding <= stride; past it the Pallas
    # kernel drops the taps beyond offsets -1..1 (a fault of the reference),
    # so there against JAX's XLA transposed conv of the same rounded operands
    emu = _phase_by_phase(xt.to(torch.bfloat16), pack_phase_taps(
        wt.to(torch.bfloat16), u, pad), bt, u, pad)
    if pad <= u:
        ref = conv_transpose1d_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                      stride=u, padding=pad, time_tile=16,
                                      interpret=True)
    else:
        xr, wr = (jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32) for a in (x, w))
        ref = jax_convt(xr, wr, jnp.asarray(b), stride=u, padding=pad)
    np.testing.assert_allclose(emu.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_conv_transpose_refuses_padding_beyond_the_stride():
    """padding > 2 * stride (k > 5 * stride, halo H = ceil(p/u) = 3) would
    need input offsets beyond -2..2, which the packed layout and the kernel
    do not hold: both the packing and the wrapper refuse it rather than
    drop taps."""
    x, w = torch.zeros(1, 32, 5), torch.zeros(32, 32, 12)  # k 12, u 2, pad 5
    with pytest.raises(ValueError, match="beyond"):
        pack_phase_taps(w, 2, 5)
    with pytest.raises(ValueError, match="beyond"):
        conv_transpose1d(x, w, None, stride=2, padding=5)


def _attn_params(rng, c, dk, w):
    def conv():
        return {"w": (rng.standard_normal((c, c, 1)) / np.sqrt(c)).astype(np.float32),
                "b": (rng.standard_normal(c) * 0.02).astype(np.float32)}

    p = {n: conv() for n in ("q", "k", "v", "o")}
    for n in ("emb_rel_k", "emb_rel_v"):
        p[n] = (rng.standard_normal((1, 2 * w + 1, dk)) * dk ** -0.5).astype(np.float32)
    return p


@pytest.mark.parametrize("b,t,lengths", [
    (1, 300, None),
    (2, 700, (700, 700)),
    (2, 700, (650, 97)),
    (1, 1100, (1025,)),
])
def test_band_attention_matches_flash_and_banded(b, t, lengths):
    """The cases of tests/test_flash_relattn.py, through the port's
    relative_attention (conv projections + band_attention_plain)."""
    rng = np.random.default_rng(0)
    c, heads, w = 192, 2, 10
    x = (rng.standard_normal((b, c, t)) * 0.3).astype(np.float32)
    params = _attn_params(rng, c, c // heads, w)
    lens = np.full(b, t) if lengths is None else np.asarray(lengths)
    mask = (np.arange(t)[None, None, :] < lens[:, None, None]).astype(np.float32)

    got = relative_attention(torch.from_numpy(x), params_to_torch(params),
                             n_heads=heads, lengths=torch.from_numpy(lens)).numpy()
    flash = np.asarray(relative_attention_flash(
        jnp.asarray(x), params_to_jax(params), n_heads=heads, window_size=w,
        frame_mask=jnp.asarray(mask), interpret=True))
    banded = np.asarray(jax_relattn(
        jnp.asarray(x), params_to_jax(params), n_heads=heads, window_size=w,
        attn_mask=jnp.asarray(mask[:, :, None, :] * mask[:, :, :, None])))
    # fp32 on every side; rows past a length are unspecified (2e-4, the
    # flash kernel's own test tolerance: exp/sum order over ~1,000 keys)
    for bi in range(b):
        v = slice(0, lens[bi])
        assert np.abs(got[bi][:, v] - flash[bi][:, v]).max() < 2e-4
        assert np.abs(got[bi][:, v] - banded[bi][:, v]).max() < 2e-4


def test_band_attention_plain_matches_dense_reference():
    """band_attention_plain against the textbook form, with the relative
    tables expanded by loops into dense (T, T) bias and value terms."""
    rng = np.random.default_rng(5)
    bh, t, dk, w = 3, 37, 8, 10
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, t, dk)).astype(np.float32))
               for _ in range(3))
    rk, rv = (torch.from_numpy(rng.standard_normal((2 * w + 1, dk)).astype(np.float32))
              for _ in range(2))
    lens = torch.tensor([37, 5, 20])
    got = band_attention_plain(q, k, v, rk, rv, lens, w)
    for i in range(bh):
        s = q[i] @ k[i].T
        bias = torch.zeros(t, t)
        rvd = torch.zeros(t, t, dk)
        for a in range(t):
            for c in range(max(0, a - w), min(t, a + w + 1)):
                bias[a, c] = q[i, a] @ rk[c - a + w]
                rvd[a, c] = rv[c - a + w]
        s = (s + bias).masked_fill(torch.arange(t)[None, :] >= lens[i], -math.inf)
        p = torch.softmax(s, -1)
        ref = p @ v[i] + torch.einsum("ts,tsd->td", p, rvd)
        n = int(lens[i])
        assert torch.allclose(got[i, :n], ref[:n], rtol=1e-5, atol=1e-5)


def test_band_attention_plain_at_bf16_operands():
    """The twin the card kernel is held to: operand_dtype rounds q, k, v
    and both tables to bf16 and computes in fp32, returning the caller's
    dtype; on already-rounded fp32 inputs it is the fp32 twin exactly."""
    rng = np.random.default_rng(6)
    bh, t, dk, w = 2, 40, 16, 10
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, t, dk)).astype(np.float32))
               for _ in range(3))
    rk, rv = (torch.from_numpy(rng.standard_normal((2 * w + 1, dk)).astype(np.float32))
              for _ in range(2))
    lens = torch.tensor([40, 23])
    bf16 = torch.bfloat16
    got = band_attention_plain(q, k, v, rk, rv, lens, w, operand_dtype=bf16)
    rounded = [a.to(bf16).float() for a in (q, k, v, rk, rv)]
    assert got.dtype == torch.float32
    assert torch.equal(got, band_attention_plain(*rounded, lens, w))
    half = band_attention_plain(q.to(bf16), k, v, rk, rv, lens, w, operand_dtype=bf16)
    assert half.dtype == bf16


def _unet_blocks(rng, c_in, c_out, n_blocks):
    blocks = []
    for j in range(n_blocks):
        ci = c_in if j == 0 else c_out
        blk = {
            "conv1": {"w": (rng.standard_normal((c_out, ci, 3, 3)) / np.sqrt(ci * 9)).astype(np.float32),
                      "b": (rng.standard_normal(c_out) * 0.05).astype(np.float32)},
            "conv2": {"w": (rng.standard_normal((c_out, c_out, 3, 3)) / np.sqrt(c_out * 9)).astype(np.float32),
                      "b": (rng.standard_normal(c_out) * 0.05).astype(np.float32)},
        }
        if ci != c_out:
            blk["shortcut"] = {
                "w": (rng.standard_normal((c_out, ci, 1, 1)) / np.sqrt(ci)).astype(np.float32),
                "b": (rng.standard_normal(c_out) * 0.05).astype(np.float32)}
        blocks.append(blk)
    return blocks


@pytest.mark.parametrize("c_in,c_out,w,fold", [
    (4, 16, 16, 8),    # channel-changing first block: 1x1 shortcut
    (16, 16, 16, 8),   # channel-preserving chain
])
def test_unet_chain_matches_pallas_and_xla(c_in, c_out, w, fold):
    rng = np.random.default_rng(c_in)
    t = 24  # two time tiles of 16, the second ragged
    blocks = _unet_blocks(rng, c_in, c_out, 2)
    x = (rng.standard_normal((1, c_in, t, w)) * 0.5).astype(np.float32)
    xt, bt = torch.from_numpy(x), params_to_torch(blocks)

    # bf16 operands on both sides (the Pallas kernel at compute_dtype bf16,
    # as the JAX F0 path runs it); summation order plus one-ulp bf16
    # re-rounding of intermediates between convs: 1e-2 absolute on
    # activations of magnitude ~5
    ref = fused_convblock_chain_folded(jnp.asarray(x), blocks, fold=fold,
                                       time_tile=16, compute_dtype=jnp.bfloat16,
                                       interpret=True)
    got = convblock_chain_plain(xt, bt, operand_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-2)

    xla = _block_chain(jnp.asarray(x), params_to_jax(blocks))
    cpu = convblock_chain(xt, bt)  # the wrapper, on a CPU tensor
    np.testing.assert_allclose(cpu.numpy(), np.asarray(xla), rtol=1e-4, atol=1e-5)

    # the CUDA kernel's weight repack, emulated: conv1 of the first block as
    # nine shifted views of the zero-padded input times the packed taps
    w1 = bt[0]["conv1"]["w"]
    taps = pack_taps_3x3(w1)
    assert taps.shape == (9, c_out, 16)  # C_out = 16: chunks of 16 channels
    xp = F.pad(torch.cat([xt, torch.zeros(1, 16 - c_in, t, w)], 1), (1, 1, 1, 1))
    emu = sum(torch.einsum("oc,bctw->botw", taps[j], xp[:, :, j // 3:j // 3 + t,
                                                     j % 3:j % 3 + w])
              for j in range(9))
    ref1 = F.conv2d(xt, w1, padding=1)
    np.testing.assert_allclose(emu.numpy(), ref1.numpy(), rtol=1e-4, atol=1e-4)

    # the Pallas kernel at fp32 operands: summation order only (1e-4)
    ref32 = fused_convblock_chain_folded(jnp.asarray(x), blocks, fold=fold,
                                         time_tile=16, compute_dtype=jnp.float32,
                                         interpret=True)
    np.testing.assert_allclose(cpu.numpy(), np.asarray(ref32), rtol=1e-4, atol=1e-4)


def test_pack_resblock_weights_layout():
    """The layout the resblock kernel reads, made once at load: each conv's
    (C, C, k) weight as (k, C_out, C_in) bf16 beside the untouched fp32
    original, which the plain twin keeps using."""
    rng = np.random.default_rng(9)
    params = params_to_torch(_resblock_params(rng, 32))
    packed = pack_resblock_weights(params)
    for p, q in zip(params, packed):
        for key in ("convs1", "convs2"):
            for conv, pc in zip(p[key], q[key]):
                assert pc["w"] is conv["w"] and pc["b"] is conv["b"]
                w = pc["w_taps"]
                assert w.dtype == torch.bfloat16 and w.is_contiguous()
                k = conv["w"].shape[-1]
                assert w.shape == (k, 32, 32)
                for j in range(k):  # bf16 rounding is the only change
                    assert torch.equal(w[j].float(), conv["w"][:, :, j].to(torch.bfloat16).float())
    assert "w_taps" not in params[0]["convs1"][0]  # the input is not mutated
    x = torch.from_numpy((rng.standard_normal((1, 32, 50)) * 0.3).astype(np.float32))
    assert torch.equal(fused_resblock_group(x, packed, KS, DS),
                       fused_resblock_group(x, params, KS, DS))


def test_pack_unet_weights_layout():
    """The U-Net kernel's layouts, made once at load: the 3x3 taps as
    pack_taps_3x3 of the bf16 weight, the 1x1 shortcut as a bf16-rounded
    (C_out, C_in) matrix held in fp32."""
    rng = np.random.default_rng(10)
    blocks = params_to_torch(_unet_blocks(rng, 4, 16, 2))
    packed = pack_unet_weights(blocks)
    for blk, pb in zip(blocks, packed):
        for name in ("conv1", "conv2"):
            assert pb[name]["w"] is blk[name]["w"]
            assert torch.equal(pb[name]["w_taps"],
                               pack_taps_3x3(blk[name]["w"].to(torch.bfloat16)))
            assert pb[name]["w_taps"].shape[-1] == 16
    sc = packed[0]["shortcut"]
    assert sc["w_mat"].dtype == torch.float32 and sc["w_mat"].shape == (16, 4)
    assert torch.equal(sc["w_mat"], blocks[0]["shortcut"]["w"][:, :, 0, 0]
                       .to(torch.bfloat16).float())
    assert "shortcut" not in packed[1] and "w_taps" not in blocks[0]["conv1"]
    x = torch.from_numpy(rng.standard_normal((1, 4, 8, 16)).astype(np.float32))
    assert torch.equal(convblock_chain(x, packed), convblock_chain(x, blocks))


@pytest.mark.parametrize("c_in,c_out,padded", [
    (1, 16, 16), (4, 16, 16), (16, 16, 16), (32, 16, 32), (48, 48, 48),
    (16, 32, 16), (64, 32, 64), (1, 64, 32), (48, 64, 64), (512, 256, 512),
    (256, 512, 256),
])
def test_unet_taps_padding(c_in, c_out, padded):
    """Input channels are padded to the kernel's chunk: 16 where C_out <= 32
    or is no multiple of 32 (C_in = 1 takes 16, not 32), 32 above; the
    padding is zeros and the taps are the weight's (dt, dw) slices."""
    w = torch.randn(c_out, c_in, 3, 3, generator=torch.Generator().manual_seed(c_in))
    taps = pack_taps_3x3(w)
    assert padded_channels(c_in, c_out) == padded
    assert taps.shape == (9, c_out, padded) and taps.is_contiguous()
    assert not taps[:, :, c_in:].any()
    for j in range(9):
        assert torch.equal(taps[j, :, :c_in], w[:, :, j // 3, j % 3])


def _chain_by_launches(x, blocks):
    """The chain as the CUDA wrapper launches it: per block, conv1 into a
    bf16 h, conv2 with the block input as residual or shortcut input into
    an fp32 block output, x's dtype for the last."""
    cur = x
    for i, blk in enumerate(blocks):
        h = unet_conv3x3_plain(cur, blk["conv1"], out_dtype=torch.bfloat16)
        cur = unet_conv3x3_plain(h, blk["conv2"], res=cur, shortcut=blk.get("shortcut"),
                                 out_dtype=x.dtype if i == len(blocks) - 1 else torch.float32)
    return cur


@pytest.mark.parametrize("c_in,c_out,t,w", [
    (1, 16, 1, 128),   # C_in = 1, one frame: every frame touches both T edges
    (1, 16, 3, 4),
    (8, 16, 2, 128),   # channel-changing first block: 1x1 shortcut
    (16, 16, 3, 128),
    (16, 32, 2, 4),
    (32, 32, 1, 4),
    (24, 48, 3, 8),
])
def test_unet_conv3x3_twin_composes_to_the_chain(c_in, c_out, t, w):
    """Eight one-launch twins (four blocks), in the wrapper's order and
    dtypes, give convblock_chain_plain at bf16 operands bit for bit, for
    fp32 and bf16 x; T = 1-3 puts every frame at a T edge."""
    rng = np.random.default_rng(c_in * 31 + t * 7 + w)
    blocks = params_to_torch(_unet_blocks(rng, c_in, c_out, 4))
    x = torch.from_numpy((rng.standard_normal((1, c_in, t, w)) * 0.5).astype(np.float32))
    for xin in (x, x.to(torch.bfloat16)):
        ref = convblock_chain_plain(xin, blocks, operand_dtype=torch.bfloat16)
        got = _chain_by_launches(xin, blocks)
        assert got.dtype == xin.dtype and torch.equal(got, ref)


def test_unet_conv3x3_twin_epilogues():
    """One launch's three epilogues: bias and ReLU alone, + the residual at
    full precision, + the 1x1 shortcut (bf16-rounded weight, fp32 input),
    each rounded once to the output dtype."""
    rng = np.random.default_rng(12)
    blk = params_to_torch(_unet_blocks(rng, 8, 16, 1))[0]
    c1, c2, sc = blk["conv1"], blk["conv2"], blk["shortcut"]
    x = torch.from_numpy(rng.standard_normal((1, 8, 5, 16)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((1, 16, 5, 16)).astype(np.float32))

    def rnd(v):
        return v.to(torch.bfloat16).float()

    y = F.relu(F.conv2d(rnd(x), rnd(c1["w"]), c1["b"], padding=1))
    assert torch.equal(unet_conv3x3_plain(x, c1), y)
    assert torch.equal(unet_conv3x3_plain(x, c1, out_dtype=torch.bfloat16),
                       y.to(torch.bfloat16))
    y2 = F.relu(F.conv2d(rnd(y), rnd(c2["w"]), c2["b"], padding=1))
    assert torch.equal(unet_conv3x3_plain(y, c2, res=r), y2 + r)
    assert torch.equal(unet_conv3x3_plain(y, c2, res=x, shortcut=sc),
                       y2 + F.conv2d(x, rnd(sc["w"]), sc["b"]))


def test_unet_chain_bf16_input_matches_pallas():
    """x in bf16, as the U-Net hands it over on the card: JAX's Pallas
    kernel (interpret mode, bf16 operands) and the port's launch-by-launch
    twin both return bf16. Tolerance: the fp32 cases' 1e-2 absolute plus
    one bf16 rounding of the output (2^-8 |ref|)."""
    rng = np.random.default_rng(21)
    c_in, c_out, t, w = 4, 16, 24, 16
    blocks = _unet_blocks(rng, c_in, c_out, 2)
    x = (rng.standard_normal((1, c_in, t, w)) * 0.5).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = fused_convblock_chain_folded(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                                       blocks, fold=8, time_tile=16,
                                       compute_dtype=jnp.bfloat16, interpret=True)
    got = _chain_by_launches(xb, params_to_torch(blocks))
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref32)
    assert np.all(err <= 1e-2 + 2.0 ** -8 * np.abs(ref32)), float(err.max())


def _bad_resblock():
    p = [{"convs1": [{"w": torch.zeros(32, 16, 3), "b": torch.zeros(32)}],
          "convs2": [{"w": torch.zeros(32, 32, 3), "b": torch.zeros(32)}]}]
    fused_resblock_group(torch.zeros(1, 32, 8), p, (3,), ((1,),))


def _bad_conv_transpose():
    from polgen_rvc_tpu_torch.ops.conv_transpose import conv_transpose1d
    conv_transpose1d(torch.zeros(1, 8, 5), torch.zeros(4, 2, 4), None,
                     stride=2, padding=1)


def _bad_band_attention():
    from polgen_rvc_tpu_torch.ops.band_attention import band_attention
    q = torch.zeros(2, 9, 4)
    band_attention(q, q, torch.zeros(2, 8, 4), torch.zeros(3, 4),
                   torch.zeros(3, 4), torch.tensor([9, 9]), 1)


def _bad_unet_chain():
    blk = {"conv1": {"w": torch.zeros(16, 2, 3, 3), "b": torch.zeros(16)},
           "conv2": {"w": torch.zeros(16, 16, 3, 3), "b": torch.zeros(16)}}
    convblock_chain(torch.zeros(1, 2, 4, 8), [blk])  # no 1x1 shortcut for 2 -> 16


def _bad_viterbi_bins():
    from polgen_rvc_tpu_torch.ops.viterbi import viterbi_path
    viterbi_path(torch.zeros(8, 361), 8)


def _bad_viterbi_dtype():
    from polgen_rvc_tpu_torch.ops.viterbi import viterbi_path
    viterbi_path(torch.zeros(8, 360, dtype=torch.float64), 8)


def _bad_viterbi_layout():
    from polgen_rvc_tpu_torch.ops.viterbi import viterbi_path
    viterbi_path(torch.zeros(360, 8).T, 8)  # a non-contiguous view


def _bad_viterbi_width():
    from polgen_rvc_tpu_torch.ops.viterbi import viterbi_path
    viterbi_path(torch.zeros(8, 360), 8, width=13)


@pytest.mark.parametrize("call", [_bad_resblock, _bad_conv_transpose,
                                  _bad_band_attention, _bad_unet_chain,
                                  _bad_viterbi_bins, _bad_viterbi_dtype,
                                  _bad_viterbi_layout, _bad_viterbi_width])
def test_kernel_wrappers_reject_shapes_that_do_not_fit(call):
    """Shapes are checked before any dispatch: the kernels take raw
    pointers, so a mismatch must raise rather than read out of bounds."""
    with pytest.raises(ValueError):
        call()
