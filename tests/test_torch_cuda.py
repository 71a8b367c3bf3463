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
from polgen_rvc_tpu_torch.ops import rnn
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


def _launches(kernel):
    from polgen_rvc_tpu_torch.utils.tracing import counters

    return counters().get(f"launches.{kernel}", 0)


def _launched(kernel, call):
    before = _launches(kernel)
    out = call()
    torch.cuda.synchronize()
    return out, _launches(kernel) - before


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
    got, n = _launched("resblock_group",
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
    got, n = _launched("resblock_group",
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
    got, n = _launched("conv_transpose",
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
    y, n = _launched("conv_transpose", lambda: ct.conv_transpose1d(
        x, up["w"], up["b"], stride=2, padding=1, taps=taps))
    ref = ct.conv_transpose1d_plain(x.float(), dec["ups"][0]["w"], dec["ups"][0]["b"],
                                    stride=2, padding=1, operand_dtype=torch.bfloat16)
    assert n == 1 and y.shape == (2, 32, 2 * t) and bool((y[:, 16:] == 0).all())
    err = (y[:, :16].float() - ref).abs()
    assert bool((err <= 2.0 ** -8 * ref.abs() + 1e-4 * ref.abs().max() + 1e-5).all())
    packed = rg.pack_resblock_weights(padded["resblocks"])
    got, n = _launched("resblock_group",
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
    got, n = _launched("band_attention",
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
    got, n = _launched("unet_chain", lambda: uc.convblock_chain(x, packed))
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
    got, n = _launched("unet_chain",
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
    got, k = _launched("viterbi", lambda: vt.viterbi_path(_t(lo, dev), n))
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


@pytest.fixture
def full_fp32():
    """fp32 matrix products and cuDNN calls without TF32, as the port's
    entry points set them (resolve_device): for the GRU's projection and
    the cuDNN yardstick."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _gru_params(rng, dev):
    """RMVPE's BiGRU (384 -> 2 x 256) in torch's layout, fan-in scaled."""
    out = {}
    for suffix in ("", "_reverse"):
        out["w_ih_l0" + suffix] = _t(rng.standard_normal((768, 384)) / np.sqrt(384), dev)
        out["w_hh_l0" + suffix] = _t(rng.standard_normal((768, 256)) / np.sqrt(256), dev)
        out["b_ih_l0" + suffix] = _t(rng.standard_normal(768) * 0.02, dev)
        out["b_hh_l0" + suffix] = _t(rng.standard_normal(768) * 0.02, dev)
    return out


def _cudnn_gru(params, x):
    """torch.nn.GRU (cuDNN on the card) with the same weights: the yardstick."""
    gru = torch.nn.GRU(384, 256, batch_first=True, bidirectional=True, device=x.device)
    with torch.no_grad():
        for name, value in gru.named_parameters():
            value.copy_(params[name.replace("weight", "w").replace("bias", "b")])
        return gru(x)[0]


@pytest.mark.parametrize("t", [1, 2, 33, 1056, 24032])
@pytest.mark.parametrize("b", [1, 2])
def test_gru_scan_kernel(dev, full_fp32, t, b):
    """The BiGRU kernel against its plain twin on the card and against
    cuDNN's nn.GRU, every value of both directions: fp32 throughout, only
    the summation order of the 256-term dot products differs (|h| <= 1).
    24,032 frames: a 240 s song's F0 pass."""
    rng = np.random.default_rng(10 * t + b)
    params = _gru_params(rng, dev)
    packed = rnn.pack_gru_weights(params)
    x = _t(rng.standard_normal((b, t, 384)) * 0.5, dev)
    got, n = _launched("gru_scan", lambda: rnn.bigru(x, packed))
    assert n == 1 and got.shape == (b, t, 512) and got.dtype == torch.float32
    twin = rnn.bigru_plain(x, params)
    assert float((got - twin).abs().max()) <= 1e-5
    assert float((got - _cudnn_gru(params, x)).abs().max()) <= 1e-5


def test_gru_scan_counts_its_launch_and_steps(dev, full_fp32):
    """One launches.gru_scan a call."""
    from polgen_rvc_tpu_torch.utils.tracing import counters

    rng = np.random.default_rng(2)
    packed = rnn.pack_gru_weights(_gru_params(rng, dev))
    for b, t in ((1, 300), (2, 77)):
        x = _t(rng.standard_normal((b, t, 384)), dev)
        before = counters()
        rnn.bigru(x, packed)
        torch.cuda.synchronize()
        after = counters()
        assert after["launches.gru_scan"] - before.get("launches.gru_scan", 0) == 1


@pytest.mark.parametrize("bad", ["float64 x", "383 wide", "non-contiguous x",
                                 "unpacked weights", "weights on the CPU",
                                 "bf16 W_hh"])
def test_gru_scan_rejects(dev, bad):
    rng = np.random.default_rng(4)
    params = _gru_params(rng, dev)
    packed = rnn.pack_gru_weights(params)
    x = _t(rng.standard_normal((1, 40, 384)), dev)
    if bad == "float64 x":
        x = x.double()
    elif bad == "383 wide":
        x = x[..., :383].contiguous()
    elif bad == "non-contiguous x":
        x = _t(rng.standard_normal((1, 80, 384)), dev)[:, ::2]
    elif bad == "unpacked weights":
        packed = params
    elif bad == "weights on the CPU":
        packed = rnn.pack_gru_weights({k: v.cpu() for k, v in params.items()})
    else:
        packed = {**packed, "w_hh_units": packed["w_hh_units"].to(torch.bfloat16)}
    with pytest.raises(ValueError):
        rnn.bigru(x, packed)


def test_gru_scan_on_a_side_stream(dev, full_fp32):
    """Launched while a side stream is current, the BiGRU kernel (and its
    projection) run on that stream, while a sleep holds the default stream:
    the result is ready before the sleep ends and matches the twin."""
    rng = np.random.default_rng(5)
    params = _gru_params(rng, dev)
    packed = rnn.pack_gru_weights(params)
    x = _t(rng.standard_normal((1, 500, 384)) * 0.5, dev)
    rnn.bigru(x, packed)  # the library loaded before the timed part
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=dev)
    torch.cuda._sleep(2_000_000_000)  # ~1 s on the default stream
    with torch.cuda.stream(side):
        got = rnn.bigru(x, packed)
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    assert not torch.cuda.default_stream(dev).query(), "the sleep ended first"
    torch.cuda.synchronize()
    assert float((got - rnn.bigru_plain(x, params)).abs().max()) <= 1e-5


def test_card_convert_never_reaches_cudnn_rnn(dev, monkeypatch):
    """A tiny rmvpe+ convert on the card with torch.nn.GRU and torch's GRU
    op patched to raise: it runs, launches the BiGRU kernel once, and its
    profile holds no cuDNN RNN kernel."""
    from torch.profiler import ProfilerActivity, profile

    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions

    def refuse(*args, **kwargs):
        raise AssertionError("torch's GRU was called on the card")

    monkeypatch.setattr(torch.nn.GRU, "__init__", refuse)
    monkeypatch.setattr(torch.nn.GRU, "forward", refuse)
    monkeypatch.setattr(torch, "gru", refuse)
    monkeypatch.setattr(torch._VF, "gru", refuse)
    vc = _tiny_converter(device=dev)
    opts = ConversionOptions(index_rate=0.5, protect=0.33, volume_envelope=0.25)
    vc.convert(_mesh_song(), opts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (out, _), n = _launched("gru_scan", lambda: vc.convert(_mesh_song(), opts))
    assert n == 1 and out.size and np.abs(out.astype(np.int32)).max() > 0
    names = [e.key for e in prof.key_averages()]
    assert names and not [k for k in names if "rnn" in k.lower()]


@pytest.mark.parametrize("c_in,c_out,t,w", [(512, 256, 225, 4), (64, 32, 1800, 32)])
def test_rmvpe_conv_transpose2d_repeats_on_the_card(dev, no_tf32, c_in, c_out, t, w):
    """RMVPE's decoder ConvTranspose2d (stride 2) at two of its levels gives
    the same bits on every call, and leaves cuDNN's deterministic flag as it
    found it (cuDNN's default choice here summed with atomics)."""
    from polgen_rvc_tpu_torch.ops.conv import conv_transpose2d

    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((1, c_in, t, w)), dev)
    wt = _t(rng.standard_normal((c_in, c_out, 3, 3)) / np.sqrt(9 * c_in), dev)
    b = _t(rng.standard_normal(c_out) * 0.02, dev)
    flag = torch.backends.cudnn.deterministic
    outs = [conv_transpose2d(x, wt, b, stride=2, padding=1, output_padding=1)
            for _ in range(4)]
    assert torch.backends.cudnn.deterministic == flag
    assert outs[0].shape == (1, c_out, 2 * t, 2 * w)
    for y in outs[1:]:
        assert torch.equal(y, outs[0])
    ref = F.conv_transpose2d(x.cpu(), wt.cpu(), b.cpu(), stride=2, padding=1,
                             output_padding=1)
    # fp32 with TF32 off (as the entry points set it): summation order only
    assert float((outs[0].cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


# ---- the decoder's bytes at every bucket ------------------------------------

# bench.py's accelerator tiers (chip_smoke.py's engine): 4 s buckets
BENCH_TIERS = dict(x_pad=1, x_query=6, x_center=30, x_max=32, chunk_batch=2,
                   bucket_step_s=4, compute_dtype="bfloat16")


def _bucket_frames():
    """(every p_len the bench tiers' buckets give, the fixed conv_pre
    length): p_len = min(bucket // 160, 2 * HuBERT frames)."""
    from polgen_rvc_tpu_torch.models.hubert import HubertConfig
    from polgen_rvc_tpu_torch.pipeline.config import EngineConfig

    eng, hub = EngineConfig(**BENCH_TIERS), HubertConfig()
    step = eng.bucket_step_s * eng.sample_rate
    lens = [min(b // eng.window, 2 * hub.num_frames(b))
            for b in range(step, eng.max_bucket_len + 1, step)]
    return lens, lens[-1]


def _rows(rng, c, valid, t, dev):
    """Two rows of t frames: row 0 the chunk under test (`valid` frames of
    data, then zeros, as the flow's masked output), row 1 another song's
    chunk filling every frame (zeroed where the chunk rides alone, as a
    serial convert's empty row)."""
    x = torch.zeros(2, c, t, dtype=torch.bfloat16, device=dev)
    x[0, :, :valid] = _t(rng.standard_normal((c, valid)) * 0.5, dev).to(torch.bfloat16)
    x[1] = _t(rng.standard_normal((c, t)) * 0.5, dev).to(torch.bfloat16)
    return x


def test_conv_pre_bytes_do_not_depend_on_the_bucket(dev):
    """The decoder's conv_pre (192 -> 512, k 7, bf16) on the same 1,198
    frames (the 9 s song's chunk) inside rows of 1,198 and 1,998 frames and
    of every p_len the bench tiers make, through the fixed-length route:
    equal bytes on the chunk's frames. The plain cuDNN conv at the row's
    own length is printed beside it (it differed between 1,198 and 1,998)."""
    from polgen_rvc_tpu_torch.models.nsf import conv_pre

    lens, fixed = _bucket_frames()
    rng = np.random.default_rng(11)
    conv = {"w": _t(rng.standard_normal((512, 192, 7)) / np.sqrt(192 * 7), dev),
            "b": _t(rng.standard_normal(512) * 0.02, dev)}
    valid = 1198
    x_full = _rows(rng, 192, valid, fixed, dev)
    fixed_out, plain_out = {}, {}
    for t in sorted({1198, 1998, *[n for n in lens if n >= valid]}):
        x = x_full[:, :, :t].clone()
        if t == valid:
            x[1] = 0
        fixed_out[t] = conv_pre(conv, x, fixed)[0, :, :valid]
        plain_out[t] = conv_pre(conv, x)[0, :, :valid]
    ref = fixed_out[valid]
    print({t: bool(torch.equal(y, plain_out[valid])) for t, y in plain_out.items()})
    for t, y in fixed_out.items():
        assert torch.equal(y, ref), f"conv_pre at {t} frames differs from {valid}"


@pytest.mark.parametrize("valid,lengths", [(1198, (1198, 1998, 4000)), (2798, (2798, 4000))])
def test_decoder_bytes_do_not_depend_on_the_bucket(dev, valid, lengths):
    """The full-width 48 kHz NSF decoder (packed weights, bf16, conv_pre at
    the bench tiers' fixed length) on the same chunk in rows of each
    length: equal bytes over the samples the engine keeps (the chunk's,
    less x_pad = 1 s at each end, past which the source's noise in the
    padded frames reaches). Covers the noise convs, conv_post and the
    kernels between them as well as conv_pre."""
    from polgen_rvc_tpu_torch.convert.params import params_to_torch
    from polgen_rvc_tpu_torch.convert.rvc_ckpt import build_config, convert_synthesizer_state
    from polgen_rvc_tpu_torch.convert.synthetic import make_rvc_checkpoint
    from polgen_rvc_tpu_torch.models.nsf import generator_nsf, pack_decoder_weights

    cpt = make_rvc_checkpoint(sr=48000, tiny=False, seed=0)
    cfg = build_config(cpt["config"], use_f0=True, version="v2")
    dec_np = convert_synthesizer_state(cpt["weight"], cfg)["dec"]
    dec = pack_decoder_weights(params_to_torch(dec_np, dev), cfg)
    _, fixed = _bucket_frames()
    rng = np.random.default_rng(12)
    z = _rows(rng, cfg.inter_channels, valid, max(lengths), dev)
    f0 = torch.zeros(2, max(lengths), device=dev)
    f0[0, :valid] = _t(180 + 60 * rng.random(valid), dev)
    f0[1] = _t(220 + 40 * rng.random(max(lengths)), dev)
    g = _t(rng.standard_normal((2, cfg.gin_channels, 1)), dev).to(torch.bfloat16)
    noise = _t(rng.standard_normal((2, fixed * cfg.upp)), dev)
    outs = {}
    with torch.inference_mode():
        for t in lengths:
            zt, ft = z[:, :, :t].clone(), f0[:, :t].clone()
            if t == valid:
                zt[1], ft[1] = 0, 0
            y = generator_nsf(dec, cfg, zt, ft, g, noise=noise, frames=fixed)
            outs[t] = y[0, cfg.sr:valid * cfg.upp - cfg.sr]
    for t, y in outs.items():
        d = (y.float() - outs[valid].float()).abs()
        assert torch.equal(y, outs[valid]), (
            f"decoder at {t} frames: {int((d > 0).sum())} samples differ, max {float(d.max())}")


@pytest.mark.parametrize("conv", ["noise_convs.0", "noise_convs.1", "noise_convs.2",
                                  "noise_convs.3", "conv_post"])
def test_decoder_library_convs_bytes_do_not_depend_on_the_length(dev, conv):
    """The decoder's other cuDNN convs, as _decode calls them (bf16, the
    full-width 48 kHz shapes), on the same 1,198-frame chunk inside rows
    of 1,198 and 1,998 frames' samples: equal bytes over the chunk's
    outputs less a 1 s margin at its end. They run at the row's own length
    (only conv_pre needed the fixed length)."""
    import math

    from polgen_rvc_tpu_torch.ops.conv import conv1d

    rates, upp, channels = (12, 10, 2, 2), 480, (256, 128, 64, 32)
    rng = np.random.default_rng(13)
    if conv == "conv_post":
        c_in, c_out, k, stride, pad = 32, 1, 7, 1, 3
    else:
        i = int(conv.split(".")[1])
        stride = math.prod(rates[i + 1:])
        c_in, c_out = 1, channels[i]
        k, pad = (stride * 2, stride // 2) if stride > 1 else (1, 0)
    w = _t(rng.standard_normal((c_out, c_in, k)) / np.sqrt(c_in * k), dev)
    b = _t(rng.standard_normal(c_out) * 0.02, dev)
    valid, margin = 1198 * upp, 48000
    outs = {}
    x_full = _rows(rng, c_in, valid, 1998 * upp, dev)
    for t in (1198 * upp, 1998 * upp):
        x = x_full[:, :, :t].clone()
        if t == valid:
            x[1] = 0
        y = conv1d(x, w, b, stride=stride, padding=pad)
        outs[t] = y[0, :, :(valid - margin) // stride]
    assert torch.equal(outs[1998 * upp], outs[valid])


def test_voice_pipeline_writes_flac_on_the_card(dev, tmp_path, monkeypatch):
    """voice_pipeline(output_format="flac") on the card, from model files
    in the app's layout: a real FLAC file from the port's native codec
    (tried before ffmpeg) whose samples decode to the int16 the convert
    gave, bit for bit."""
    from polgen_rvc_tpu_torch.app import voice_conversion
    from polgen_rvc_tpu_torch.native import flac
    from polgen_rvc_tpu_torch.pipeline.factory import write_synthetic_files
    from polgen_rvc_tpu_torch.utils.audio_io import write_audio

    write_synthetic_files(str(tmp_path), "voice", tiny=True, index_vectors=256)
    monkeypatch.chdir(tmp_path)
    t = np.arange(2 * 44100) / 44100
    x = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    write_audio("in.wav", np.stack([x, 0.8 * x], 1), 44100)
    written = []

    def keep(path, samples, sr):
        written.append(np.array(samples))
        return write_audio(path, samples, sr)

    monkeypatch.setattr(voice_conversion, "write_audio", keep)
    try:
        path = voice_conversion.voice_pipeline("in.wav", "voice", 0, index_rate=0.5,
                                               output_format="flac", device="cuda")
    finally:
        voice_conversion._CONVERTER_CACHE.clear()
    assert path.endswith("Voice_Converted.flac") and open(path, "rb").read(4) == b"fLaC"
    y, sr = flac.decode(path)
    (want,) = written
    assert sr == 48000 and want.dtype == np.int16 and y.shape == (want.shape[0], 1)
    assert np.array_equal((y[:, 0] * 32768).astype(np.int16), want)


def test_two_threads_share_a_converter(dev):
    """One converter, as the UI server's job threads or two callers share
    it, converting two different songs from two threads at once, three
    times: each output equals its serial convert byte for byte (the kernel
    builds and loads are locked; RMVPE's transposed convs flip cuDNN's
    process-global deterministic flag under a lock while the other thread's
    convs are planned)."""
    import threading

    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
    from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter

    vc = build_synthetic_converter(
        tiny=True, sr=48000, index_vectors=256, device=dev,
        engine=EngineConfig(x_pad=1, x_query=2, x_center=3, x_max=4, chunk_batch=2,
                            bucket_step_s=2, compute_dtype="bfloat16"))
    opts = ConversionOptions(index_rate=0.5, protect=0.33, volume_envelope=0.25)
    rng = np.random.default_rng(21)
    songs = []
    for seconds, f0 in ((6.0, 220.0), (4.5, 330.0)):
        t = np.arange(int(seconds * 16000)) / 16000
        songs.append((0.4 * np.sin(2 * np.pi * f0 * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t)))
                      + 0.01 * rng.standard_normal(t.size)).astype(np.float32))
    serial = [vc.convert(s, opts)[0] for s in songs]
    for _ in range(3):
        barrier = threading.Barrier(2)
        outs, errors = [None, None], []

        def work(i):
            try:
                barrier.wait(timeout=30)
                outs[i] = vc.convert(songs[i], opts)[0]
                torch.cuda.synchronize()
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors and not any(t.is_alive() for t in threads), errors
        for got, want in zip(outs, serial):
            assert got.shape == want.shape and np.array_equal(got, want)


def test_kernel_on_a_side_stream(dev):
    """A kernel launched while a side stream is current runs on that
    stream: the default stream is held busy by a sleep queued first, and
    the kernel's result is ready (its event on the side stream has fired)
    while the sleep still runs. The result matches the plain twin."""
    rng = np.random.default_rng(31)
    u, k, pad = 10, 20, 5
    x = _t(rng.standard_normal((2, 64, 300)) * 0.5, dev)
    w = _t(rng.standard_normal((64, 32, k)) / np.sqrt(64 * k), dev)
    b = _t(rng.standard_normal(32) * 0.02, dev)
    taps = ct.pack_phase_taps(w.to(torch.bfloat16), u, pad)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=dev)
    torch.cuda._sleep(2_000_000_000)  # ~1 s on the default stream
    with torch.cuda.stream(side):
        got = ct.conv_transpose1d(x, w, b, stride=u, padding=pad, taps=taps)
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    assert not torch.cuda.default_stream(dev).query(), "the sleep ended first"
    torch.cuda.synchronize()
    ref = ct.conv_transpose1d_plain(x, w, b, stride=u, padding=pad,
                                    operand_dtype=torch.bfloat16)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def _mesh_song(seconds=5.0):
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.4 * np.sin(2 * np.pi * 220 * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t)))
            ).astype(np.float32)


def _tiny_converter(**kw):
    from polgen_rvc_tpu_torch.pipeline.config import EngineConfig
    from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter

    return build_synthetic_converter(
        tiny=True, sr=48000, index_vectors=256,
        engine=EngineConfig(x_pad=1, x_query=1, x_center=2, x_max=3, chunk_batch=2,
                            bucket_step_s=2, compute_dtype="bfloat16"), **kw)


def test_program_spans_put_nothing_on_the_card(dev):
    """A profiled tiny convert: the port's polgen.* spans are host records
    only (no device event carries their names), the request span and the
    chunk batch's are among them, and the card ran kernels."""
    from torch.profiler import ProfilerActivity, profile

    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions

    vc = _tiny_converter(device=dev)
    opts = ConversionOptions(index_rate=0.5, protect=0.33, volume_envelope=0.25)
    vc.convert(_mesh_song(), opts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        vc.convert(_mesh_song(), opts)
        torch.cuda.synchronize()
    host, device = set(), []
    for e in prof.profiler.kineto_results.events():
        (host.add(e.name()) if str(e.device_type()).endswith("CPU")
         else device.append(e.name()))
    assert {"polgen.convert", "polgen.chunk_batch", "polgen.rmvpe.bigru"} <= host
    assert device and not [n for n in device if n.startswith("polgen.")]


def test_convert_on_a_repeated_card_mesh(dev):
    """A tiny convert on a 2x1 data mesh of cuda:0 named twice (one row a
    data shard): within the repo's 0.5 dB gate of the unsharded convert,
    the synthesizer's kernels launched once a data shard a batch; on a
    1x1 mesh, the unsharded bytes. The tiny widths are not held byte for
    byte on 2x1: the card picks some of their calls' algorithms by row
    count (the tiny HuBERT's 64-channel first conv; in fp32 also
    retrieval's einsum), and ops/conv.py:at_rows pads only the calls the
    published widths need (their bytes are held by
    test_one_row_shard_gives_the_batch_bytes_at_every_bucket)."""
    from polgen_rvc_tpu_torch.parallel import make_mesh
    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions
    from polgen_rvc_tpu_torch.utils.metrics import mel_distortion_db

    opts = ConversionOptions(index_rate=0.5, protect=0.33, volume_envelope=0.25)
    song = _mesh_song()
    want, sr = _tiny_converter(device=dev).convert(song, opts)
    vc = _tiny_converter(mesh=make_mesh(2, devices=["cuda:0"] * 2))
    n_batches = len(vc._batch_geometry(vc._prepare_song(song, opts).plan)[0])
    cfg = vc.synth_cfg
    pairs = len(cfg.upsample_rates) * sum(len(d) for d in cfg.resblock_dilation_sizes)
    before = _launches("resblock_group")
    got, _ = vc.convert(song, opts)
    assert _launches("resblock_group") - before == pairs * 2 * n_batches
    assert got.shape == want.shape
    assert mel_distortion_db(got, want, sr) < 0.5
    one, _ = _tiny_converter(mesh=make_mesh(1, devices=["cuda:0"])).convert(song, opts)
    np.testing.assert_array_equal(one, want)


def test_convert_on_two_cards(dev, monkeypatch):
    """Below two cards, skip. Else a 2x1 data mesh over cuda:0 and cuda:1,
    with cuda:0 current: every launch of the synthesizer's three kernels
    goes to its tensors' card, each kernel launches on both cards, and the
    convert is within 0.5 dB of the unsharded one."""
    from polgen_rvc_tpu_torch.ops import cuda_build
    from polgen_rvc_tpu_torch.parallel import make_mesh
    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions
    from polgen_rvc_tpu_torch.utils.metrics import mel_distortion_db

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    seen = {}
    real = cuda_build.launch

    def spy(fn, device, *args):
        seen.setdefault(fn.__name__, set()).add(device)
        assert torch.cuda.current_device() == 0  # the launch guards, not the caller
        return real(fn, device, *args)

    monkeypatch.setattr(cuda_build, "launch", spy)
    opts = ConversionOptions(index_rate=0.5, protect=0.33, volume_envelope=0.25)
    song = _mesh_song()
    torch.cuda.set_device(0)
    want, sr = _tiny_converter(device="cuda:0").convert(song, opts)
    mesh = make_mesh(2, devices=["cuda:0", "cuda:1"])
    got, _ = _tiny_converter(mesh=mesh).convert(song, opts)
    cards = {torch.device("cuda:0"), torch.device("cuda:1")}
    for name in ("resblock_pair", "conv_transpose_upsample", "band_attention"):
        assert seen[name] == cards, (name, seen[name])
    assert got.shape == want.shape
    assert mel_distortion_db(got, want, sr) < 0.5


def _bench_like_song(seconds, sr=16000):
    """A vibrato sine with its octave and light noise, as bench.py's."""
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * sr)) / sr
    vibrato = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t)
    return (0.4 * np.sin(2 * np.pi * 220.0 * t * vibrato)
            + 0.1 * np.sin(2 * np.pi * 440.0 * t)
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


_BENCH_TIERS = dict(x_pad=1, x_query=6, x_center=30, x_max=32, chunk_batch=2,
                    bucket_step_s=4, compute_dtype="bfloat16")
_FULL = {}


def _full_width(use_f0):
    """The full-width 48 kHz v2 model (f0 or no-f0) at bench's tiers in bf16,
    with the 60 s song prepared on it; built once per model."""
    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
    from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter

    if use_f0 not in _FULL:
        vc = build_synthetic_converter(tiny=False, sr=48000, index_vectors=65536,
                                       engine=EngineConfig(**_BENCH_TIERS),
                                       device="cuda", use_f0=use_f0)
        opts = ConversionOptions(index_rate=0.5, protect=0.33, volume_envelope=0.25)
        with torch.inference_mode():
            _FULL[use_f0] = vc, opts, vc._prepare_song(_bench_like_song(60.0), opts)
    return _FULL[use_f0]


@pytest.mark.parametrize("use_f0", [True, False], ids=["f0", "nof0"])
@pytest.mark.parametrize("bucket_s", range(4, 49, 4))
def test_one_row_shard_gives_the_batch_bytes_at_every_bucket(dev, bucket_s, use_f0):
    """At every bucket class of bench's tiers (4-48 s), a packed two-row
    batch's row work (_shard_rows), run on both rows and on each row alone
    as a 2x1 mesh's data shard runs it: each row alone gives the two-row
    batch's bytes. (Before the row-count route, enc_p's FFN conv2 and the
    flow's WaveNet in convs at 1,198-1,998 frames, HuBERT's attention
    product at 798 and its group-norm sums at 4,398-4,798 gave other
    bytes.)"""
    from polgen_rvc_tpu_torch.pipeline.chunking import Chunk

    vc, opts, prep = _full_width(use_f0)
    eng = vc.engine
    bucket, w = bucket_s * eng.sample_rate, eng.window
    lens = (bucket - eng.sample_rate // 2, bucket * 3 // 4 // w * w)
    mid = (prep.buf.shape[0] - lens[1]) // 2 // w * w
    chunks = [Chunk(0, 0, start, start + n) for start, n in zip((0, mid), lens)]
    p_len = min(bucket // w, 2 * vc.hubert_cfg.num_frames(bucket))
    with torch.inference_mode():
        rows = vc._assemble_rows([(c, ci, prep.buf, prep.pitch, prep.pitchf)
                                  for ci, c in enumerate(chunks)], p_len)
        inp = vc._batch_inputs(rows, bucket, p_len)
        rest = (bucket, p_len, opts, True, use_f0)
        shard = vc._data_shards()[0]
        both = vc._shard_rows(shard, inp, *rest)
        for r in range(2):
            alone = vc._shard_rows(shard, {k: None if v is None else v[r:r + 1]
                                           for k, v in inp.items()}, *rest)
            assert torch.equal(alone[0], both[r]), (bucket_s, r)


HOSTS_CODE = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from polgen_rvc_tpu_torch.parallel import convert_batch_across_hosts, init_hosts, make_mesh
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter
songs = [np.load(p) for p in SONGS]
vc = build_synthetic_converter(tiny=False, sr=48000, index_vectors=65536,
                               engine=EngineConfig(**TIERS),
                               mesh=make_mesh(2, devices=["cuda:0"] * 2))
init_hosts(PORT, 2, RANK, timeout_s=300)
out = convert_batch_across_hosts(vc, songs, ConversionOptions(**OPTS))
dist.destroy_process_group()
if RANK == 0:
    for i, (audio, _) in enumerate(out):
        np.save(f"{OUT}/song{i}.npy", audio)
"""


def test_two_ranks_on_one_card_give_one_process_bytes(dev, tmp_path):
    """convert_batch_across_hosts over two gloo ranks, each on a local 2x1
    mesh over cuda:0 (a row a data shard), on 23 and 9 s songs of the
    full-width model: every gathered song equals one process's
    convert_batch of both, byte for byte (packed together there, each
    alone on a rank)."""
    import socket
    import subprocess
    import sys
    import time
    from pathlib import Path

    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
    from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter

    song = _bench_like_song(60.0)
    paths = []
    for i, seconds in enumerate((23, 9)):
        paths.append(str(tmp_path / f"in{i}.npy"))
        np.save(paths[-1], song[:seconds * 16000])
    opts = dict(index_rate=0.5, protect=0.33, volume_envelope=0.25)
    with socket.create_server(("127.0.0.1", 0)) as s:
        port = s.getsockname()[1]
    repo = Path(__file__).resolve().parents[1]
    head = (f"SONGS, TIERS, OPTS, PORT, OUT = {paths!r}, {_BENCH_TIERS!r}, {opts!r}, "
            f"{port}, {str(tmp_path)!r}\n")
    procs = [subprocess.Popen([sys.executable, "-c", f"RANK = {rank}\n{head}{HOSTS_CODE}"],
                              cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(2)]
    deadline = time.monotonic() + 600
    try:
        results = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
                   for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err
    vc = build_synthetic_converter(tiny=False, sr=48000, index_vectors=65536,
                                   engine=EngineConfig(**_BENCH_TIERS), device="cuda")
    refs = vc.convert_batch([np.load(p) for p in paths], ConversionOptions(**opts))
    for i, (ref, _) in enumerate(refs):
        np.testing.assert_array_equal(np.load(tmp_path / f"song{i}.npy"), ref)


# ---- the conversion head (ops/highpass.py) ----------------------------------

def _hp_signal(n, seed=0):
    rng = np.random.default_rng(seed + n)
    t = np.arange(n) / 16000
    return (0.4 * np.sin(2 * np.pi * 220.0 * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t)))
            + 0.2 * np.sin(2 * np.pi * 20.0 * t)
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _hp_lengths():
    from polgen_rvc_tpu_torch.ops import highpass as hp

    one_tile = hp.TILE - 2 * hp.PADLEN
    return (hp.PADLEN + 1, 100, one_tile - 1, one_tile, one_tile + 1, 32000, 163840)


@pytest.mark.parametrize("case", range(7))
@pytest.mark.parametrize("t_pad", [0, 250, 16000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_highpass_kernel_matches_twin(dev, case, t_pad, dtype):
    """Every length around a tile, a pad wider than the signal, float32 and
    float64 input: the kernel's signal, int16 buffer, inverse scale and
    dequantized buffer are the twin's bit for bit (the same operations in
    the same order: lfilter's steps, the carry's sums, numpy's rounding)."""
    from polgen_rvc_tpu_torch.ops import highpass as hp

    x = _hp_signal(_hp_lengths()[case]).astype(dtype)
    got, n = _launched("highpass", lambda: hp.highpass_pad_quant(
        torch.from_numpy(x).to(dev), t_pad))
    want = hp.highpass_pad_quant_plain(torch.from_numpy(x), t_pad)
    assert n == 1
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w)


def test_highpass_kernel_on_a_240_s_song(dev):
    """A 240 s song of the benchmark's generator: the kernel against its
    twin (bit for bit) and against the host's scipy head (the int16 buffer
    within one count, on at most 2e-3 of the samples: the blocked scan and
    scipy's sequential pass round differently, ~1e-7 of the peak apart);
    the launch counter moves; the converter's plan (from the host's own
    float32 signal) is the host's, and its buffer the kernel's."""
    import json

    from benchmark.signals import Inputs
    from polgen_rvc_tpu_torch.ops import filters
    from polgen_rvc_tpu_torch.ops import highpass as hp
    from polgen_rvc_tpu_torch.pipeline.chunking import plan_chunks
    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
    from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter
    from polgen_rvc_tpu_torch.utils.tracing import counters

    traffic = json.loads(open("benchmark/traffic/songs.json").read())
    x = Inputs(traffic, 4000000777).signal(3, 0)
    assert x.shape[0] == 240 * 16000
    before = counters()
    got = hp.highpass_pad_quant(torch.from_numpy(x).to(dev), 16000)
    torch.cuda.synchronize()
    after = counters()
    assert after["launches.highpass"] - before.get("launches.highpass", 0) == 1
    twin = hp.highpass_pad_quant_plain(torch.from_numpy(x), 16000)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, twin))
    h_audio, h_q, h_inv, _ = filters.highpass_pad_quant(x, 16000)
    audio = got[0].cpu().numpy()
    assert np.abs(audio - h_audio).max() <= 1e-6 * np.abs(h_audio).max()
    dq = np.abs(got[1].cpu().numpy().astype(np.int32) - h_q)
    assert dq.max() <= 1 and (dq > 0).mean() <= 2e-3

    vc = build_synthetic_converter(tiny=True, sr=48000, engine=EngineConfig(),
                                   device=dev, use_f0=False)
    song = vc._prepare_song(x, ConversionOptions())
    assert song.plan == plan_chunks(h_audio, EngineConfig())
    assert np.array_equal(song.audio, h_audio)
    assert torch.equal(song.buf, got[3])


@pytest.mark.parametrize("seconds", [5.0, 2.0], ids=["cut", "not_cut"])
def test_prepare_song_issues_the_f0_pass_without_a_host_sync(dev, monkeypatch, seconds):
    """The card is held busy by a sleep queued first; _prepare_song uploads
    the song, launches the high-pass and reaches the F0 pass while the
    sleep still runs (nothing waited on the card), under torch's sync
    debug mode set to raise on any synchronizing call; the F0 pass then
    reads the kernel's buffer. A song the planner cuts (t_max 3 s here) is
    planned on the host's signal, a shorter one on the card's."""
    from polgen_rvc_tpu_torch.ops import filters
    from polgen_rvc_tpu_torch.ops import highpass as hp
    from polgen_rvc_tpu_torch.pipeline.chunking import plan_chunks
    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions

    vc = _tiny_converter(device=dev)
    opts = ConversionOptions(index_rate=0.5, protect=0.33, volume_envelope=0.25)
    song = _mesh_song(seconds)
    vc._prepare_song(song, opts)   # builds and loads what it launches
    torch.cuda.synchronize()
    seen = {}
    real_f0 = vc.compute_f0

    def f0_pass(buf, *a, **k):
        torch.cuda.set_sync_debug_mode("default")
        seen["sleeping"] = not torch.cuda.current_stream(dev).query()
        seen["buf"] = buf.clone()
        return real_f0(buf, *a, **k)

    monkeypatch.setattr(vc, "compute_f0", f0_pass)
    torch.cuda._sleep(2_000_000_000)  # ~1 s
    torch.cuda.set_sync_debug_mode("error")
    try:
        prep = vc._prepare_song(song, opts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert seen["sleeping"], "the host waited for the card before the F0 pass"
    card = hp.highpass_pad_quant(torch.from_numpy(song).to(dev), vc.engine.t_pad,
                                 vc.engine.window)
    assert torch.equal(seen["buf"], card[3]) and torch.equal(prep.buf, card[3])
    host = filters.highpass_pad_quant(song, vc.engine.t_pad)[0]
    want = host if seconds == 5.0 else card[0].cpu().numpy()
    assert np.array_equal(prep.audio, want)
    assert prep.plan == plan_chunks(want, vc.engine)
    assert len(prep.plan.chunks) == (3 if seconds == 5.0 else 1)
