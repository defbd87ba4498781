"""TTS synthesis CLI: a podcast script -> a wav file (port of
``speech_distill_tpu/pipelines/synthesize.py``).

The reference's inference entry path (``initiate_model`` +
``process_single_input`` + ``forward_longform``;
soulxpodcast/utils/infer_utils.py) on ``--device`` (default cuda,
raising without it).
"""
from __future__ import annotations

import argparse
import json
import os


def build_parser():
    from speech_distill_tpu_torch.pipelines.common import add_device_arg
    p = argparse.ArgumentParser(description="SoulX-Podcast TTS synthesis")
    p.add_argument("--model_path", type=str, required=True,
                   help="dir with LLM safetensors + flow.pt + hift.pt + "
                        "tokenizer + speech_tokenizer_v2.pt")
    p.add_argument("--script", type=str, required=True,
                   help="podcast JSON script (speakers + text) or JSONL "
                        "datalist")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--llm_engine", type=str, default="jax",
                   help="jax: the contiguous-cache DecodeEngine; paged: "
                        "the PagedEngine")
    p.add_argument("--fp16_flow", action="store_true")
    p.add_argument("--streaming", action="store_true",
                   help="stream wav chunks per turn while the LLM decodes "
                        "(chunk-causal incremental synthesis; logs "
                        "first-audio latency per turn)")
    add_device_arg(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import time

    import numpy as np
    from scipy.io.wavfile import write as wav_write

    from speech_distill_tpu_torch.infer.infer_utils import (
        check_models, initiate_model, process_single_input)
    from speech_distill_tpu_torch.utils.parser import podcast_format_parser

    model, dataset = initiate_model(args.seed, args.model_path,
                                    args.llm_engine, args.fp16_flow,
                                    device=args.device)

    with open(args.script, encoding="utf-8") as f:
        data = json.load(f)
    entry = podcast_format_parser(data, args.output_dir)

    inputs = process_single_input(
        dataset, entry["text"], entry["prompt_wav"], entry["prompt_text"],
        entry["use_dialect_prompt"], entry["dialect_prompt_text"])
    check_models(args.model_path, inputs)

    os.makedirs(args.output_dir, exist_ok=True)
    if args.streaming:
        chunks, cur, t_mark = [], -1, time.perf_counter()
        for turn, wav_chunk in model.forward_longform_streaming(**inputs):
            if turn != cur:
                # first audio of this turn, from the end of the previous
                # turn's audio (the turn's decode + the first chunk)
                dt = time.perf_counter() - t_mark
                print(f"turn {turn}: first audio after {dt * 1e3:.0f} ms")
                cur = turn
            chunks.append(wav_chunk)
            t_mark = time.perf_counter()
        wav = np.concatenate(chunks)
    else:
        out = model.forward_longform(**inputs)
        wav = np.concatenate(out["generated_wavs"])
    wav_write(entry["wav"], 24000, (wav * 32767).astype(np.int16))
    print(f"Saved {entry['wav']} ({wav.shape[0] / 24000:.2f}s)")
    return entry["wav"]


if __name__ == "__main__":
    main()
