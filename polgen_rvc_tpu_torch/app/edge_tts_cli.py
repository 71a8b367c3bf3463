"""Edge-TTS voice-over CLI: python -m polgen_rvc_tpu_torch.app.edge_tts_cli

The flags, defaults and types of the JAX package's app/edge_tts_cli.py.
Speech synthesis needs Microsoft's service; the conversion runs on the
CUDA card."""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Synthesize speech and replace the voice; output in output/",
        add_help=True,
    )
    # Exact reference flags (-i/--text_input, -v/--tts_voice); the previous
    # round's -t/--text and --voice spellings are kept as aliases.
    parser.add_argument("-i", "--text_input", "-t", "--text",
                        dest="text_input", type=str, required=True)
    parser.add_argument("-v", "--tts_voice", "--voice",
                        dest="tts_voice", type=str, required=True)
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
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from .edge_tts_conversion import edge_tts_pipeline
    from .voice_conversion import RVC_MODELS_DIR
    from ..utils.progress import ProgressReporter

    if not os.path.exists(os.path.join(RVC_MODELS_DIR, args.model_name)):
        raise SystemExit(
            f"\033[91mModel {args.model_name} does not exist; "
            "check the name.\033[0m"
        )

    converted, _tts = edge_tts_pipeline(
        text=args.text_input,
        voice_model=args.model_name,
        voice=args.tts_voice,
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
    print(f"\033[1;92m\nSpeech synthesized and voice replaced: {converted}\033[0m")


if __name__ == "__main__":
    main()
