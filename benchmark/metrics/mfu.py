"""mfu (%): the whole convert's share of the card's peak over the timed
window: the operations of every model on the path, each over the peak
of the precision it runs in (bf16 989, fp32 67 TFLOP/s; TF32 is off),
summed, over the window's wall seconds. Counted from each song's valid
frames and each chunk's valid slice with the published widths, so
padding (buckets, empty batch rows, the F0 buffer's zero tail) is no
work. Products and convolutions only; norms, activations, the FFTs'
butterflies and the top-k are left out.

Precisions, as the port runs them: HuBERT, enc_p, the flow, the decoder,
RMVPE's U-Net 3x3 chains and CREPE's convs in bf16; the retrieval
distances, RMVPE's transposed convs, head, BiGRU and classifier, the mel
filterbank and CREPE's classifier in fp32. The F0 pass's count is its
model's own (``flops`` of its module in ``benchmark/f0/``)."""

import math

from benchmark import f0, peaks
from benchmark.reference.signal import hubert_frames
from benchmark.work import chunk_frames, chunks

def _hubert(samples: int, h: dict, layers: int, final_proj: bool) -> float:
    t, in_c, f = samples, 1, 0.0
    for dim, k, s in h["conv_layers"]:
        t = (t - k) // s + 1
        f += 2 * dim * in_c * k * t
        in_c = dim
    d = h["embed_dim"]
    f += 2 * in_c * d * t
    f += 2 * d * (d // h["pos_conv_groups"]) * h["pos_conv_kernel"] * t
    f += layers * (4 * 2 * d * d * t + 2 * 2 * t * t * d + 2 * 2 * d * h["ffn_dim"] * t)
    if final_proj:
        f += 2 * d * h["final_dim"] * t
    return f


def _synth(v: int, cfg: list, content: int, use_f0: bool) -> float:
    (_, _, inter, hid, filt, _, n_layers, kernel, _, _, res_k, res_d,
     rates, up0, up_k, _, _, _) = cfg
    f = 2 * content * hid * v
    f += n_layers * (4 * 2 * hid * hid * v + 4 * v * v * hid + 4 * v * 21 * hid
                     + 2 * 2 * hid * filt * kernel * v)
    f += 2 * hid * 2 * inter * v
    flow = 2 * (inter // 2) * hid * v + 2 * hid * (inter // 2) * v
    flow += 3 * 2 * hid * 2 * hid * 5 * v + 2 * (2 * 2 * hid * hid * v) + 2 * hid * hid * v
    f += 4 * flow
    f += 2 * inter * up0 * 7 * v
    t = v
    for i, (u, k) in enumerate(zip(rates, up_k)):
        c_in, c = up0 // 2 ** i, up0 // 2 ** (i + 1)
        f += 2 * c_in * c * k * t
        t *= u
        if use_f0:
            sf = math.prod(rates[i + 1:])
            f += 2 * c * (2 * sf if sf > 1 else 1) * t
        f += 4 * c * c * t * sum(kk * len(d) for kk, d in zip(res_k, res_d))
    return f + 2 * (up0 // 2 ** len(rates)) * 7 * t


def flops(config, engine, window) -> dict:
    """{dtype: operations} of the window's calls."""
    syn, h, opts = config["synthesizer"], config["hubert"], config["options"]
    cfg, use_f0, v1 = syn["config"], bool(syn["f0"]), syn["version"] == "v1"
    content = h["final_dim"] if v1 else h["embed_dim"]
    layers = 9 if (v1 and h["n_layers"] >= 9) else h["n_layers"]
    out = {"bfloat16": 0.0, "float32": 0.0}
    if use_f0:
        f0_model = f0.find(config["f0_model"])
        for song in window.songs:
            for k, v in f0_model.flops(config, engine, song["padded_len"]).items():
                out[k] += v
    use_index = config.get("index_vectors", 0) and opts["index_rate"] > 0
    for length in chunks(window):
        v = chunk_frames(length, config, engine)
        out["bfloat16"] += _hubert(length, h, layers, v1) + _synth(v, cfg, content, use_f0)
        if use_index:
            hub = hubert_frames(length, h["conv_layers"])
            out["float32"] += 2 * config["index_vectors"] * content * hub
    return out


def read(ctx):
    if ctx.window.wall_s <= 0:
        return None
    ops = flops(ctx.config, ctx.engine, ctx.window)
    busy = sum(f / peaks.FLOPS[dtype] for dtype, f in ops.items())
    return 100.0 * busy / ctx.window.wall_s
