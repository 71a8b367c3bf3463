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
filterbank and CREPE's classifier in fp32."""

import math

from benchmark import peaks
from benchmark.reference.signal import hubert_frames
from benchmark.work import chunk_frames, chunks

N_BLOCKS = 4


def _rmvpe(n: float) -> dict:
    """RMVPE on n frames: {dtype: operations}."""
    bf = fp = 0.0
    levels = []
    c_in, c = 1, 16
    for i in range(5):
        levels.append((c_in, c, n / 2 ** i, 128 / 2 ** i))
        c_in, c = c, c * 2
    for i in range(4):
        levels.append((256 if i == 0 else 512, 512, n / 32, 4))
    c = 512
    for i in range(5):
        oc = c // 2
        t_in, w_in = n / 2 ** (5 - i), 4 * 2 ** i
        fp += 2 * 9 * c * oc * t_in * w_in                 # transposed conv
        levels.append((2 * oc, oc, n / 2 ** (4 - i), 8 * 2 ** i))
        c = oc
    for c_in, c, t, w in levels:
        for j in range(N_BLOCKS):
            cin = c_in if j == 0 else c
            bf += 2 * 9 * (cin * c + c * c) * t * w
            if cin != c:
                bf += 2 * cin * c * t * w
    fp += 2 * 9 * 16 * 3 * n * 128                            # head conv
    fp += n * 2 * 2 * 3 * 256 * (384 + 256)                   # BiGRU
    fp += n * (2 * 512 * 360 + 2 * 128 * 513)                 # classifier, mel basis
    return {"bfloat16": bf, "float32": fp}


def _crepe(n: float, layers) -> dict:
    """CREPE on n frames of 1024 samples."""
    bf, positions, c_in = 0.0, 1024, 1
    for c_out, k, stride, pt, pb in layers:
        out = (positions + pt + pb - k) // stride + 1
        bf += 2 * c_out * c_in * k * out
        positions, c_in = out // 2, c_out
    return {"bfloat16": n * bf, "float32": n * 2 * positions * c_in * 360}


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
    for song in window.songs:
        if not use_f0:
            continue
        if config.get("f0_model") == "crepe":
            part = _crepe(song["padded_len"] // int(opts["hop_length"]) + 1,
                          config["crepe"]["layers"])
        else:
            part = _rmvpe(song["padded_len"] // engine.window + 1)
        for k, v in part.items():
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
