"""Unified CLI: ``python -m speech_distill_tpu_torch <command> [flags]``
(port of ``speech_distill_tpu/__main__.py``).

Commands map 1:1 to the reference's top-level scripts. ``SDT_FORCE_CPU=1``
adds ``--device cpu`` (the CLIs run on the GPU otherwise, and raise
without one).
"""
import importlib
import os
import sys

COMMANDS = {
    "prepare-student": ("speech_distill_tpu_torch.pipelines.prepare_student",
                        "expand student vocab to the teacher's"),
    "stage1": ("speech_distill_tpu_torch.pipelines.stage1",
               "stage-1 warm-up (new speech-token embeddings)"),
    "prepare-dataset": ("speech_distill_tpu_torch.pipelines.prepare_dataset",
                        "offline audio -> aligned input-id preprocessing"),
    "extract-logits": ("speech_distill_tpu_torch.pipelines.extract_logits",
                       "teacher top-K logprob extraction"),
    "train": ("speech_distill_tpu_torch.pipelines.train",
              "stage-2 knowledge distillation"),
    "synthesize": ("speech_distill_tpu_torch.pipelines.synthesize",
                   "TTS synthesis from a podcast script"),
    "evaluate": ("speech_distill_tpu_torch.pipelines.evaluate",
                 "distilled-model quality eval (agreement/KL + audio smoke)"),
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m speech_distill_tpu_torch <command> [flags]\n")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:18s} {desc}")
        sys.exit(0 if len(sys.argv) >= 2 else 1)
    cmd = sys.argv[1]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd}; one of {', '.join(COMMANDS)}")
        sys.exit(1)
    module, _ = COMMANDS[cmd]
    argv = sys.argv[2:]
    if os.environ.get("SDT_FORCE_CPU") and not any(
            a == "--device" or a.startswith("--device=") for a in argv):
        argv += ["--device", "cpu"]
    importlib.import_module(module).main(argv)


if __name__ == "__main__":
    main()
