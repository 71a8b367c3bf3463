"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
test, never at import). On a machine with a card and nvcc, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports jax, which the port's
machine need not have; this file imports neither jax nor the JAX package.)
The shapes here are the edges the main path does not reach: ragged tiles,
every upsample rate, every mel width, dk below the tile, Viterbi ties and
lengths. Inputs are made with numpy from a seed; each tolerance says why.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from polgen_rvc_tpu_torch.ops import band_attention as ba
from polgen_rvc_tpu_torch.ops import conv_transpose as ct
from polgen_rvc_tpu_torch.ops import resblock_group as rg
from polgen_rvc_tpu_torch.ops import unet_chain as uc
from polgen_rvc_tpu_torch.ops import viterbi as vt

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


def _launched(fn, call):
    before = fn.launches
    out = call()
    torch.cuda.synchronize()
    return out, fn.launches - before


def _resblock_params(rng, c, dev):
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    params = [{key: [{"w": _t(rng.standard_normal((c, c, k)) / np.sqrt(c * k), dev),
                      "b": _t(rng.standard_normal(c) * 0.02, dev)} for _ in d]
               for key in ("convs1", "convs2")} for k, d in zip(ks, ds)]
    return params, ks, ds


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [5, 37, 129, 300, 1000])
@pytest.mark.parametrize("c", [32, 64, 96, 128, 256])
def test_resblock_group_kernel(dev, c, t, dtype):
    """Every tile shape (C = 32, 64/128, 96, 256), T ragged against every
    tile and shorter than the deepest halo, x in bf16 and in fp32."""
    rng = np.random.default_rng(c + t)
    params, ks, ds = _resblock_params(rng, c, dev)
    x = _t(rng.standard_normal((2, c, t)) * 0.3, dev).to(dtype)
    packed = rg.pack_resblock_weights(params)
    got, n = _launched(rg.fused_resblock_group,
                       lambda: rg.fused_resblock_group(x, packed, ks, ds))
    ref = rg.resblock_group_plain(x, params, ks, ds, operand_dtype=torch.bfloat16)
    assert n == 9 and got.dtype == dtype and got.shape == x.shape
    # bf16 operands both sides; an intermediate near a bf16 rounding boundary
    # may round one ulp apart before the next of 18 convs
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max())


@pytest.mark.parametrize("mode", ["stream", "sum", "mean"])
@pytest.mark.parametrize("c,t", [(32, 300), (64, 129), (96, 37), (128, 5), (256, 200)])
def test_resblock_pair_kernel(dev, c, t, mode):
    """One launch (k = 11, d = 5) at fp32 x against resblock_pair_plain on
    the same bf16-rounded operands. Tolerance: fp32 summation order (1e-4 of
    max |ref|) plus one bf16 ulp of h (<= 2^-7 |h|) wherever the two round
    h on either side of a boundary, carried through conv2:
    conv_{k,1}(2^-7 |h|, |W2|)."""
    rng = np.random.default_rng(7 * c + t)
    params, ks, ds = _resblock_params(rng, c, dev)
    k, d = ks[-1], ds[-1][-1]
    c1, c2 = params[-1]["convs1"][-1], params[-1]["convs2"][-1]
    p1, p2 = (rg.pack_resblock_weights([{"convs1": [c1], "convs2": [c2]}])[0][key][0]
              for key in ("convs1", "convs2"))
    x = _t(rng.standard_normal((2, c, t)) * 0.3, dev)
    acc = _t(rng.standard_normal((2, c, t)), dev)
    kw = {"stream": {}, "sum": {"acc": acc},
          "mean": {"acc": acc, "last": True, "n_res": 3}}[mode]
    got, n = _launched(rg.fused_resblock_group,
                       lambda: rg.resblock_pair(x, p1, p2, k, d, **kw))
    bf16 = torch.bfloat16
    ref = rg.resblock_pair_plain(x, c1, c2, k, d, operand_dtype=bf16, **kw)
    h = F.leaky_relu(F.conv1d(F.leaky_relu(x, 0.1).to(bf16).float(),
                              c1["w"].to(bf16).float(), c1["b"],
                              padding=d * (k - 1) // 2, dilation=d), 0.1)
    ulp_h = F.conv1d(2.0 ** -7 * h.to(bf16).float().abs(), c2["w"].to(bf16).float().abs(),
                     padding=(k - 1) // 2) / (kw.get("n_res", 1))
    assert n == 1 and got.dtype == torch.float32
    limit = 1e-4 * float(ref.abs().max()) + ulp_h
    assert bool(((got - ref).abs() <= limit).all()), float((got - ref).abs().max())


def test_resblock_group_rejects_channels_off_the_tile(dev):
    for c in (48, 288):
        x = torch.zeros(1, c, 64, device=dev)
        p = [{"convs1": [{"w": torch.zeros(c, c, 3, device=dev),
                          "b": torch.zeros(c, device=dev)}],
              "convs2": [{"w": torch.zeros(c, c, 3, device=dev),
                          "b": torch.zeros(c, device=dev)}]}]
        with pytest.raises(ValueError, match="multiple of 32"):
            rg.fused_resblock_group(x, rg.pack_resblock_weights(p), (3,), ((1,),))


def test_kernel_wrappers_reject_unpacked_weights(dev):
    """On the card the kernels read only the layouts made at load; a
    weight that was never packed raises instead of being packed per call."""
    x = torch.zeros(1, 32, 64, device=dev)
    p = [{key: [{"w": torch.zeros(32, 32, 3, device=dev),
                 "b": torch.zeros(32, device=dev)}] for key in ("convs1", "convs2")}]
    with pytest.raises(ValueError, match="not packed"):
        rg.fused_resblock_group(x, p, (3,), ((1,),))
    w4 = torch.zeros(32, 32, 4, device=dev)
    with pytest.raises(ValueError, match="pack_phase_taps"):
        ct.conv_transpose1d(x, w4, torch.zeros(32, device=dev), stride=2, padding=1)
    # the earlier (u, 3, C_out, C_in) layout, zero taps included, is refused
    with pytest.raises(ValueError, match="pack_phase_taps"):
        ct.conv_transpose1d(x, w4, torch.zeros(32, device=dev), stride=2, padding=1,
                            taps=torch.zeros(2, 3, 32, 32, device=dev,
                                             dtype=torch.bfloat16))
    blk = {n: {"w": torch.zeros(32, 32, 3, 3, device=dev),
               "b": torch.zeros(32, device=dev)} for n in ("conv1", "conv2")}
    with pytest.raises(ValueError, match="pack_unet_weights"):
        uc.convblock_chain(torch.zeros(1, 32, 4, 16, device=dev), [blk])


@pytest.mark.parametrize("u,k,c_in,c_out,t,dtype", [
    (12, 24, 64, 32, 70, torch.float32),
    (10, 20, 32, 64, 33, torch.float32),
    (8, 16, 32, 32, 5, torch.float32),
    (4, 8, 96, 32, 129, torch.float32),
    (2, 4, 64, 96, 31, torch.float32),
    (10, 16, 32, 64, 33, torch.float32),    # k < 2u: phases 3..6 one tap
    (8, 12, 32, 32, 40, torch.float32),
    (12, 24, 64, 32, 1, torch.float32),     # T_in off the tile
    (2, 4, 64, 32, 129, torch.float32),
    (4, 4, 32, 32, 17, torch.float32),      # padding 0: one tap a phase
    (2, 6, 32, 32, 20, torch.float32),      # padding = u: three taps a phase
    (12, 24, 512, 64, 100, torch.float32),  # stage-0 width, fp32 tile
    (12, 24, 64, 32, 70, torch.bfloat16),   # the bf16 route the decoder takes
    (12, 24, 512, 64, 100, torch.bfloat16),
    (10, 20, 256, 128, 200, torch.bfloat16),
    (10, 20, 32, 64, 129, torch.bfloat16),
    (10, 16, 32, 32, 1, torch.bfloat16),
    (8, 12, 32, 32, 33, torch.bfloat16),
    (2, 4, 128, 64, 257, torch.bfloat16),
    # halo 2 (padding > stride): v1 32 kHz's second stage, u = 4, k = 16,
    # offsets -2..2, four taps a phase; and u = 2, k = 8
    (4, 16, 256, 128, 1, torch.float32),
    (4, 16, 256, 128, 129, torch.float32),
    (4, 16, 256, 128, 257, torch.float32),
    (4, 16, 256, 128, 1, torch.bfloat16),
    (4, 16, 256, 128, 129, torch.bfloat16),
    (4, 16, 256, 128, 257, torch.bfloat16),
    (2, 8, 64, 32, 1, torch.float32),
    (2, 8, 64, 32, 129, torch.float32),
    (2, 8, 64, 32, 257, torch.float32),
    (2, 8, 64, 32, 1, torch.bfloat16),
    (2, 8, 64, 32, 129, torch.bfloat16),
    (2, 8, 64, 32, 257, torch.bfloat16),
])
def test_conv_transpose_kernel(dev, u, k, c_in, c_out, t, dtype):
    """Every tap count a phase can have, halos of 1 and 2, ragged tiles,
    rows of T_out off the 16-byte vector (scalar stores), fp32 and bf16 in
    and out."""
    rng = np.random.default_rng(u * 1000 + k * 10 + t)
    pad = (k - u) // 2
    x = _t(rng.standard_normal((2, c_in, t)) * 0.5, dev).to(dtype)
    w = _t(rng.standard_normal((c_in, c_out, k)) / np.sqrt(c_in * k), dev)
    b = _t(rng.standard_normal(c_out) * 0.02, dev)
    taps = ct.pack_phase_taps(w.to(torch.bfloat16), u, pad)
    got, n = _launched(ct.conv_transpose1d,
                       lambda: ct.conv_transpose1d(x, w, b, stride=u, padding=pad,
                                                   taps=taps))
    ref = ct.conv_transpose1d_plain(x.float(), w, b, stride=u, padding=pad,
                                    operand_dtype=torch.bfloat16)
    assert n == 1 and got.shape == (2, c_out, t * u) and got.dtype == dtype
    if dtype == torch.float32:
        # identical bf16-rounded operands: fp32 summation order only
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    else:
        # one bf16 rounding of the fp32 result, plus fp32 summation order
        err = (got.float() - ref).abs()
        assert bool((err <= 2.0 ** -8 * ref.abs() + 1e-4 * ref.abs().max()).all())


def test_conv_transpose_refuses_a_halo_of_three(dev):
    """padding > 2 * stride (u = 2, k = 12, padding 5: offsets -3..3) is
    refused on the card as on the CPU, by the packing and the wrapper."""
    x = torch.zeros(1, 32, 16, device=dev)
    w = torch.zeros(32, 32, 12, device=dev)
    with pytest.raises(ValueError, match="beyond"):
        ct.pack_phase_taps(w.to(torch.bfloat16), 2, 5)
    with pytest.raises(ValueError, match="beyond"):
        ct.conv_transpose1d(x, w, None, stride=2, padding=5,
                            taps=torch.zeros(12, 32, 32, device=dev,
                                             dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [33, 300])
def test_padded_sixteen_wide_stage(dev, t, dtype):
    """A v1 decoder's last stage (32 -> 16 channels, u = 2, k = 4) as the
    converter loads it, padded to 32 (models/nsf.py:pad_decoder_stages):
    the conv-transpose and resblock-group kernels on the padded weights
    give the unpadded twins' channels and exact zeros in the padding.
    Tolerances as test_conv_transpose_kernel and test_resblock_group_kernel."""
    from types import SimpleNamespace

    from polgen_rvc_tpu_torch.models.nsf import pad_decoder_stages

    rng = np.random.default_rng(16 + t)
    params, ks, ds = _resblock_params(rng, 16, dev)
    dec = {"ups": [{"w": _t(rng.standard_normal((32, 16, 4)) / np.sqrt(128), dev),
                    "b": _t(rng.standard_normal(16) * 0.02, dev)}],
           "resblocks": params,
           "conv_post": {"w": _t(rng.standard_normal((1, 16, 7)) * 0.1, dev), "b": None}}
    padded = pad_decoder_stages(dec, SimpleNamespace(resblock_kernel_sizes=ks))
    up = padded["ups"][0]
    assert up["w"].shape == (32, 32, 4) and padded["conv_post"]["w"].shape == (1, 32, 7)
    x = _t(rng.standard_normal((2, 32, t)) * 0.5, dev).to(dtype)
    taps = ct.pack_phase_taps(up["w"].to(torch.bfloat16), 2, 1)
    y, n = _launched(ct.conv_transpose1d, lambda: ct.conv_transpose1d(
        x, up["w"], up["b"], stride=2, padding=1, taps=taps))
    ref = ct.conv_transpose1d_plain(x.float(), dec["ups"][0]["w"], dec["ups"][0]["b"],
                                    stride=2, padding=1, operand_dtype=torch.bfloat16)
    assert n == 1 and y.shape == (2, 32, 2 * t) and bool((y[:, 16:] == 0).all())
    err = (y[:, :16].float() - ref).abs()
    assert bool((err <= 2.0 ** -8 * ref.abs() + 1e-4 * ref.abs().max() + 1e-5).all())
    packed = rg.pack_resblock_weights(padded["resblocks"])
    got, n = _launched(rg.fused_resblock_group,
                       lambda: rg.fused_resblock_group(y, packed, ks, ds))
    ref = rg.resblock_group_plain(y[:, :16], params, ks, ds, operand_dtype=torch.bfloat16)
    assert n == 9 and got.dtype == dtype and bool((got[:, 16:] == 0).all())
    err = float((got[:, :16].float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max())


def test_conv_transpose_rejects_channels_off_the_tile(dev):
    x = torch.zeros(1, 32, 16, device=dev)
    with pytest.raises(ValueError, match="multiples of 32"):
        ct.conv_transpose1d(x, torch.zeros(32, 48, 4, device=dev), None,
                            stride=2, padding=1)


@pytest.mark.parametrize("bh,t,dk,lengths,rel_scale", [
    (4, 300, 96, (300, 250, 64, 1), 1.0),
    (2, 77, 16, (77, 40), 1.0),
    (3, 130, 128, (130, 129, 65), 1.0),
    (2, 200, 96, (200, 131), 8.0),  # large rel_k: p peaks on the band
    (2, 1000, 96, (1000, 100), 1.0),  # whole blocks past row 1's length
    (1, 1001, 96, (1001,), 1.0),      # T ragged against the 64-row tile
    (1, 256, 96, (256,), 8.0),        # the key split at 128 crosses the band
    (2, 300, 96, (300, 290), 8.0),    # 5 tiles: the split at 192 in the band
])
def test_band_attention_kernel(dev, bh, t, dk, lengths, rel_scale):
    rng = np.random.default_rng(t + dk)
    w = 10
    q = _t(rng.standard_normal((bh, t, dk)) / np.sqrt(dk), dev)
    k, v = (_t(rng.standard_normal((bh, t, dk)), dev) for _ in range(2))
    rk = _t(rng.standard_normal((2 * w + 1, dk)) * rel_scale, dev)
    rv = _t(rng.standard_normal((2 * w + 1, dk)) * dk ** -0.5, dev)
    lens = torch.tensor(lengths, device=dev)
    got, n = _launched(ba.band_attention,
                       lambda: ba.band_attention(q, k, v, rk, rv, lens, w))
    bf16 = torch.bfloat16
    ref = ba.band_attention_plain(q, k, v, rk, rv, lens, w, operand_dtype=bf16)
    p_abs_v = ba.band_attention_plain(q, k, v.abs(), rk, torch.zeros_like(rv), lens,
                                      w, operand_dtype=bf16)
    assert n == 1 and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())  # rows past a length too
    # the same bf16 operands both sides; the kernel rounds p to bf16 (unit
    # roundoff 2^-8) before the value product, so per element
    # |err| <= 2^-8 sum_u p_u |v_u|, plus fp32 summation order; rows past a
    # length are unspecified
    for i, n_valid in enumerate(lengths):
        err = (got[i, :n_valid] - ref[i, :n_valid]).abs()
        limit = 2.0 ** -8 * p_abs_v[i, :n_valid] + 1e-4 * ref[i, :n_valid].abs().max()
        assert bool((err <= limit).all()), float((err - limit).max())
    # bf16 in, bf16 out, no cast around the launch
    got16 = ba.band_attention(*(a.to(bf16) for a in (q, k, v, rk, rv)), lens, w)
    assert got16.dtype == bf16
    for i, n_valid in enumerate(lengths):
        torch.testing.assert_close(got16[i, :n_valid].float(), got[i, :n_valid],
                                   rtol=2 ** -8, atol=1e-5)  # one bf16 rounding


def test_band_attention_rejects_windows_past_the_tile(dev):
    """The band's 2w + 1 rel-key rows must fit one 64-key tile slot."""
    q = torch.zeros(1, 64, 16, device=dev)
    w = ba.BLOCK_ROWS // 2
    rel = torch.zeros(2 * w + 1, 16, device=dev)
    with pytest.raises(ValueError, match="window"):
        ba.band_attention(q, q, q, rel, rel, torch.tensor([64], device=dev), w)


# every (C_in, C_out, W) family of the main path's U-Net levels, from enc0's
# first conv to the intermediate and dec0 levels, and C_out = 48
_UNET_FAMILIES = [(1, 16, 128), (16, 16, 128), (32, 16, 128), (16, 32, 64),
                  (32, 32, 64), (64, 32, 64), (32, 64, 32), (128, 64, 32),
                  (64, 128, 16), (256, 128, 16), (128, 256, 8), (512, 256, 8),
                  (256, 512, 4), (512, 512, 4), (48, 48, 16)]
# T ragged against every tile (TT = 2, 4, 8, 16 frames): 1, 2, 9, 33, 225;
# then the cases of earlier versions of this test
_UNET_CASES = ([(ci, co, t, w) for ci, co, w in _UNET_FAMILIES for t in (1, 2, 9, 33, 225)]
               + [(1, 16, 37, 128), (16, 32, 20, 64), (48, 48, 9, 16), (64, 32, 50, 8),
                  (256, 256, 33, 4)])


def _unet_blocks(rng, c_in, c_out, dev, n_blocks=2):
    blocks = []
    for j in range(n_blocks):
        ci = c_in if j == 0 else c_out
        blk = {name: {"w": _t(rng.standard_normal((c_out, cc, 3, 3)) / np.sqrt(cc * 9), dev),
                      "b": _t(rng.standard_normal(c_out) * 0.05, dev)}
               for name, cc in (("conv1", ci), ("conv2", c_out))}
        if ci != c_out:
            blk["shortcut"] = {"w": _t(rng.standard_normal((c_out, ci, 1, 1)) / np.sqrt(ci), dev),
                               "b": _t(rng.standard_normal(c_out) * 0.05, dev)}
        blocks.append(blk)
    return blocks


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c_in,c_out,t,w", _UNET_CASES)
def test_unet_chain_kernel(dev, c_in, c_out, t, w, dtype):
    rng = np.random.default_rng(c_in + w + t)
    blocks = _unet_blocks(rng, c_in, c_out, dev)
    x = _t(rng.standard_normal((1, c_in, t, w)), dev).to(dtype)
    packed = uc.pack_unet_weights(blocks)
    got, n = _launched(uc.convblock_chain, lambda: uc.convblock_chain(x, packed))
    ref = uc.convblock_chain_plain(x.float(), blocks, operand_dtype=torch.bfloat16)
    assert n == 4 and got.shape == (1, c_out, t, w) and got.dtype == dtype
    # bf16 operands both sides; one-ulp re-rounding between the 4 convs
    assert float((got.float() - ref).abs().max()) <= 1e-2 * float(ref.abs().max())


@pytest.fixture
def no_tf32():
    """The plain twin's fp32 1x1 shortcut as a full fp32 cuDNN conv, as the
    port's entry points set it (resolve_device): TF32 would round its fp32
    input to 10 bits."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["h", "cur", "last"])
@pytest.mark.parametrize("c_in,c_out,t,w", [(1, 16, 33, 128), (16, 32, 9, 64),
                                            (64, 64, 33, 32), (128, 128, 9, 16),
                                            (128, 256, 33, 8), (512, 512, 225, 4)])
def test_unet_conv3x3_kernel(dev, no_tf32, c_in, c_out, t, w, kind, dtype):
    """One launch against unet_conv3x3_plain on the same input: conv1 into
    bf16 h ("h"), conv2 with the residual or shortcut into the fp32 block
    output ("cur") or into x's dtype ("last"). Both round the same operands
    to bf16, so the fp32 results differ by summation order only (1e-4 of
    max |ref| + 1e-5); a bf16 output adds one rounding of it (2^-8 |ref|)."""
    rng = np.random.default_rng(c_in * 3 + w + len(kind))
    blk = uc.pack_unet_weights(_unet_blocks(rng, c_in, c_out, dev, 1))[0]
    x = _t(rng.standard_normal((1, c_in, t, w)), dev).to(dtype)
    if kind == "h":
        args, out_dtype = dict(), torch.bfloat16
        src, conv = x, blk["conv1"]
    else:
        args = dict(res=x, shortcut=blk.get("shortcut"))
        out_dtype = dtype if kind == "last" else torch.float32
        src = _t(rng.standard_normal((1, c_out, t, w)), dev).to(torch.bfloat16)
        conv = blk["conv2"]
        if "shortcut" not in blk:
            args["res"] = _t(rng.standard_normal((1, c_out, t, w)), dev).to(dtype)
    got, n = _launched(uc.convblock_chain,
                       lambda: uc.unet_conv3x3(src, conv, out_dtype=out_dtype, **args))
    ref = uc.unet_conv3x3_plain(src, conv, **args)
    assert n == 1 and got.dtype == out_dtype and got.shape == (1, c_out, t, w)
    limit = 1e-4 * float(ref.abs().max()) + 1e-5
    if out_dtype == torch.bfloat16:
        limit = limit + 2.0 ** -8 * ref.abs()
    err = (got.float() - ref).abs()
    assert bool((err <= limit).all()), float(err.max())


def test_unet_chain_rejects_shapes_off_the_tile(dev):
    """C_out off the 16-multiple grid, and W that does not divide 128 (or
    is below 4), raise before any launch."""
    rng = np.random.default_rng(4)
    for c_out, w in ((24, 16), (16, 12), (16, 2), (32, 256)):
        blk = uc.pack_unet_weights(_unet_blocks(rng, c_out, c_out, dev, 1))
        with pytest.raises(ValueError, match="multiple of 16|divide 128"):
            uc.convblock_chain(torch.zeros(1, c_out, 5, w, device=dev), blk)


def _viterbi_log_obs(rng, t, n, plateau):
    """A random-walk peak over low noise, masked edges, all-tie frames and
    garbage rows past n (the CPU tests' cases, any length)."""
    probs = rng.random((t, 360)).astype(np.float32) * 0.01
    c = np.clip(100 + np.cumsum(rng.integers(-3, 4, t)), 0, 359)
    probs[np.arange(t), c] = 0.9
    probs[:, :40] = 0.0
    probs[:, 300:] = 0.0
    if plateau:
        probs[50:70, :] = 0.0
    if n < t:
        probs[n:] = rng.random((t - n, 360)).astype(np.float32)
    obs = probs / np.maximum(probs.sum(1, keepdims=True), 1e-20)
    return np.log(obs + 1e-20).astype(np.float32)


def _viterbi_tie(m_bin, plateau):
    """Step 1 meets an exact fp32 tie between the teleport candidate from
    m_bin and bin `plateau`'s in-band best (see test_torch_crepe.py)."""
    bc = vt.band_table()[plateau, 11]
    target = np.float32(np.float32(vt.LOG_INIT + np.float32(0.0)) + vt.LOG_EPS)
    x = np.float32(target - bc - vt.LOG_INIT)
    for _ in range(64):
        v = np.float32(np.float32(vt.LOG_INIT + x) + bc)
        if v == target:
            break
        x = np.nextafter(x, np.float32(np.inf if v < target else -np.inf),
                         dtype=np.float32)
    lo = np.full((3, 360), -100.0, np.float32)
    lo[0, m_bin] = 0.0
    lo[0, plateau - 15:plateau + 16] = x
    lo[1:, plateau] = 0.0
    return lo


# the walk takes n - 1 backpointer rows in spans of vt.SPAN and the spans'
# maps in chunks of vt.WALK_MAPS: these n put the rows at a span and a
# chunk of spans, one or two more, and two of them and two more
_SPAN_NS = [k * vt.SPAN + d for k in (1, 2) for d in (0, 1, 2)]
_CHUNK_NS = [k * vt.SPAN * vt.WALK_MAPS + d for k in (1, 2) for d in (0, 1, 2)]


@pytest.mark.parametrize("case", ["240/240", "240/224/plateau", "130/111",
                                  "64/64/plateau", "1/1", "2/1", "tie/0/200",
                                  "tie/359/100", "20000/19001", "7751/7751",
                                  "7751/7700/plateau"]
                         + [f"{n + 40}/{n}" for n in _SPAN_NS + _CHUNK_NS])
def test_viterbi_kernel(dev, case):
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("tie"):
        lo, n = _viterbi_tie(*(int(v) for v in case.split("/")[1:])), 3
    else:
        t, n = (int(v) for v in case.split("/")[:2])
        lo = _viterbi_log_obs(rng, t, n, case.endswith("plateau"))
    got, k = _launched(vt.viterbi_path, lambda: vt.viterbi_path(_t(lo, dev), n))
    # the plain twin, which the CPU tests hold to JAX's scan and Pallas
    # paths: only fp32 adds, compares and subtracts, so exactly equal
    ref = vt.viterbi_path(torch.from_numpy(lo), n)
    assert k == 1 and got.dtype == torch.int32
    assert torch.equal(got.cpu(), ref)


def test_viterbi_kernel_matches_twin_on_the_card(dev):
    rng = np.random.default_rng(11)
    lo = _t(_viterbi_log_obs(rng, 700, 650, True), dev)
    assert torch.equal(vt.viterbi_path(lo, 650), vt.viterbi_path_plain(lo, 650))


@pytest.mark.parametrize("bad", ["float64", "361 bins", "non-contiguous"])
def test_viterbi_rejects(dev, bad):
    lo = {"float64": lambda: torch.zeros(8, 360, dtype=torch.float64, device=dev),
          "361 bins": lambda: torch.zeros(8, 361, device=dev),
          "non-contiguous": lambda: torch.zeros(360, 8, device=dev).T}[bad]()
    with pytest.raises(ValueError):
        vt.viterbi_path(lo, 8)
