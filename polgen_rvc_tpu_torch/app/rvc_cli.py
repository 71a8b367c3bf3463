"""Voice-conversion CLI: python -m polgen_rvc_tpu_torch.app.rvc_cli

The flags, defaults and types of the JAX package's app/rvc_cli.py. The
conversion runs on the CUDA card; --profile DIR writes a torch.profiler
Chrome trace of it, with the request ids of its spans, into DIR/trace.json
and what the port's counters gained into DIR/counters.json
(utils/tracing.py)."""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Replace the voice in a track; output lands in output/",
        add_help=True,
    )
    parser.add_argument("-i", "--song_input", type=str, required=True)
    parser.add_argument("-m", "--model_name", type=str, required=True)
    parser.add_argument("-p", "--pitch", type=float, required=True)
    parser.add_argument("-ir", "--index_rate", type=float, default=0)
    parser.add_argument("-fr", "--filter_radius", type=int, default=3)
    parser.add_argument("-rms", "--volume_envelope", type=float, default=0.25)
    parser.add_argument("-f0", "--method", type=str, default="rmvpe+")
    parser.add_argument("-hop", "--hop_length", type=int, default=128)
    parser.add_argument("-pro", "--protect", type=float, default=0.33)
    parser.add_argument("-f0min", "--f0_min", type=int, default=50)
    parser.add_argument("-f0max", "--f0_max", type=int, default=1100)
    parser.add_argument("-f", "--format", type=str, default="mp3")
    parser.add_argument("--profile", type=str, default=None,
                        help="write a torch.profiler Chrome trace and the port's "
                             "counters to this directory")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..utils.progress import ProgressReporter
    from ..utils.tracing import maybe_profile
    from .voice_conversion import RVC_MODELS_DIR, voice_pipeline

    if not os.path.exists(os.path.join(RVC_MODELS_DIR, args.model_name)):
        raise SystemExit(
            f"\033[91mModel {args.model_name} does not exist; "
            "check the name.\033[0m"
        )

    with maybe_profile(args.profile):
        cover_path = voice_pipeline(
            uploaded_file=args.song_input,
            voice_model=args.model_name,
            pitch=args.pitch,
            index_rate=args.index_rate,
            filter_radius=args.filter_radius,
            volume_envelope=args.volume_envelope,
            f0_method=args.method,
            hop_length=args.hop_length,
            protect=args.protect,
            f0_min=args.f0_min,
            f0_max=args.f0_max,
            output_format=args.format,
            progress=ProgressReporter(),
        )
    print(f"\033[1;92m\nVoice replaced successfully: {cover_path}\033[0m")
    return cover_path


if __name__ == "__main__":
    main()
