"""The operation and byte counts against hand counts on small shapes."""

from benchmark import peaks, spec
from benchmark.reference.signal import Engine
from benchmark.work import Window

ENGINE = Engine()


def window(slices, padded_len=48_000, batches=1):
    song = {"audio_s": 1.0, "padded_len": padded_len, "buffer_len": 163_840,
            "slices": slices}
    return Window([{"songs": [song], "batches": batches}], 2.0)


def config(rates=(2, 2), up0=8, res_k=(3,), res_d=((1,),), hidden=4, heads=2, layers=1):
    cfg = [9, 32, 4, hidden, 8, heads, layers, 3, 0, "1", list(res_k),
           [list(d) for d in res_d], list(rates), up0, [4] * len(rates), 1, 4, 48000]
    hub = {"conv_layers": [[4, 10, 5], [4, 3, 2], [4, 3, 2], [4, 3, 2], [4, 3, 2],
                           [4, 2, 2], [4, 2, 2]], "embed_dim": 4, "ffn_dim": 8,
           "n_heads": 2, "n_layers": 1, "pos_conv_kernel": 4, "pos_conv_groups": 2,
           "final_dim": 2}
    return {"synthesizer": {"config": cfg, "version": "v2", "f0": 1}, "hubert": hub,
            "options": {"hop_length": 128, "index_rate": 0.0}, "f0_model": "rmvpe"}


# a slice of 3,520 samples: 10 HuBERT frames, 20 synthesizer frames
SLICE, FRAMES = 3_520, 20


def test_resblock_counts():
    w, c = window([SLICE]), config()
    flops, nbytes = spec.load_metric("resblock_roofline").work(c, ENGINE, w)
    # stage 0: C=4 at 40 samples, stage 1: C=2 at 80; one resblock, k=3, d=(1,):
    # 2 convs of 2 C^2 k T
    assert flops == 2 * 2 * 16 * 3 * 40 + 2 * 2 * 4 * 3 * 80
    act = 2 * 2 * (4 * 40 + 2 * 80)
    wts = 2 * (16 * 3 * 2 + 4 * 4) + 2 * (4 * 3 * 2 + 4 * 2)
    assert nbytes == act + wts


def test_resblock_counts_v1_at_its_valid_widths():
    """v1 32 kHz: five stages from 512 channels, the fifth 16 wide; its
    work is counted at 16 channels, not the 32 the port pads it to."""
    c = spec.load_config("v1_32k_rmvpe")
    engine = Engine(**c["engine"])
    flops, _ = spec.load_metric("resblock_roofline").work(c, engine, window([SLICE]))
    stages = [(256, FRAMES * 10), (128, FRAMES * 40), (64, FRAMES * 80), (32, FRAMES * 160),
              (16, FRAMES * 320)]
    # three ResBlock1 (k 3, 7, 11; dilations 1, 3, 5): 2 * 3 convs of 2 C^2 k T each
    assert flops == sum(2 * 3 * 2 * c * c * (3 + 7 + 11) * t for c, t in stages)


def test_upsample_counts():
    w, c = window([SLICE], batches=2), config()
    flops, nbytes = spec.load_metric("upsample_roofline").work(c, ENGINE, w)
    # 8 -> 4 at 20 samples (k 4), 4 -> 2 at 40 (k 4)
    assert flops == 2 * 8 * 4 * 4 * 20 + 2 * 4 * 2 * 4 * 40
    act = 2 * (8 * 20 + 4 * 40) + 2 * (4 * 40 + 2 * 80)
    wts = (2 * 8 * 4 * 4 + 4 * 4) + (2 * 4 * 2 * 4 + 4 * 2)
    assert nbytes == act + 2 * wts


def test_band_attention_counts():
    w, c = window([SLICE]), config()
    flops, nbytes = spec.load_metric("band_attention_roofline").work(c, ENGINE, w)
    t, h = FRAMES, 4
    assert flops == 4 * t * t * h + 4 * t * 21 * h
    assert nbytes == 2 * 4 * t * h + 2 * 2 * 21 * 2


def test_unet_counts_valid_frames_only():
    mod = spec.load_metric("unet_roofline")
    f, wb = mod.chain_work(1, 16, 32, 128)
    conv = 2 * 9 * 32 * 128
    assert f == conv * (1 * 16 + 16 * 16) + 2 * 32 * 128 * 16 + 3 * conv * (2 * 16 * 16)
    small = mod.work(config(), ENGINE, window([SLICE], padded_len=3_040))[0]
    big = mod.work(config(), ENGINE, window([SLICE], padded_len=6_240))[0]
    assert abs(big / small - 2.0) < 1e-12   # 20 and 40 valid frames, whatever the buffer


def test_viterbi_counts():
    c = config()
    flops, nbytes = spec.load_metric("viterbi_roofline").work(c, ENGINE, window([SLICE], 1280))
    n = 1280 // 128 + 1
    assert flops == n * 360 * 49
    assert nbytes == 4 * n * 360 + 4 * n + 4 * 360 * 23


def test_mfu_holds_the_kernels_counts():
    """The whole-path count covers each roofline's operations."""
    cfg = spec.load_config("v2_48k_rmvpe")
    w = window([480_000 + 32_160, 300_000], padded_len=812_000, batches=1)
    total = spec.load_metric("mfu").flops(cfg, ENGINE, w)["bfloat16"]
    parts = sum(spec.load_metric(m).work(cfg, ENGINE, w)[0] for m in
                ("resblock_roofline", "upsample_roofline", "band_attention_roofline",
                 "unet_roofline"))
    assert parts < total
    assert peaks.bound_s({"bfloat16": 989e12}, 0) == 1.0
    assert peaks.bound_s({"float32": 0.0}, 3.35e12) == 1.0
