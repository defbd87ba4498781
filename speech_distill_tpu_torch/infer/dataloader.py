"""Inference dataset: podcast scripts -> per-speaker prompt features
(port of ``speech_distill_tpu/infer/dataloader.py``; reference
``PodcastDataset`` / ``PodcastInferHandler``,
soulxpodcast/utils/dataloader.py:33-295).

Per prompt wav (resampled and volume-normalised on the host) it computes:
  (a) the 16 kHz S3 tokenizer log-mel [128, T], on the dataset's device
  (b) the Kaldi fbank (host) -> a CAM++ speaker embedding through
      ``spk_emb_fn`` (``models/campplus.make_spk_emb_fn``, or onnxruntime
      through :func:`make_onnx_spk_emb_fn`)
  (c) the 24 kHz 80-mel of the flow's prompt, on the device (trimmed to
      an even length)
and builds the speaker-tagged prompt text
``<|task_podcast|><|SPEAKER_i|><|text_start|>...<|text_end|><|semantic_token_start|>``.
The item holds numpy arrays, as JAX's does.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from speech_distill_tpu_torch.audio.fbank import fbank
from speech_distill_tpu_torch.audio.mel import (audio_volume_normalize,
                                                log_mel_spectrogram,
                                                mel_spectrogram)
from speech_distill_tpu_torch.audio.resample import resample
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.utils.text import normalize_text

SPK_DICT = ["<|SPEAKER_0|>", "<|SPEAKER_1|>", "<|SPEAKER_2|>", "<|SPEAKER_3|>"]
TEXT_START = "<|text_start|>"
TEXT_END = "<|text_end|>"
AUDIO_START = "<|semantic_token_start|>"
TASK_PODCAST = "<|task_podcast|>"


def load_wav(path: str):
    from scipy.io.wavfile import read as wav_read
    sr, data = wav_read(path)
    data = np.asarray(data, np.float32)
    if data.ndim > 1:
        data = data[:, 0]
    if np.abs(data).max() > 2.0:  # int16-range
        data = data / 32768.0
    return data, sr


def make_onnx_spk_emb_fn(model_dir: str) -> Callable[[np.ndarray], np.ndarray]:
    """CAM++ speaker embedding through onnxruntime on the CPU
    (dataloader.py:93-102). Imports onnxruntime when called and raises
    ``ImportError`` without it."""
    import onnxruntime
    option = onnxruntime.SessionOptions()
    option.graph_optimization_level = \
        onnxruntime.GraphOptimizationLevel.ORT_ENABLE_ALL
    option.intra_op_num_threads = 1
    sess = onnxruntime.InferenceSession(
        os.path.join(model_dir, "campplus.onnx"), sess_options=option,
        providers=["CPUExecutionProvider"])

    def fn(feat: np.ndarray) -> np.ndarray:
        return sess.run(
            None, {sess.get_inputs()[0].name: feat[None]})[0].flatten()

    return fn


class PodcastDataset:
    """JSONL of multi-speaker scripts -> prompt feature items. The mels
    are computed on ``device`` (CUDA by default; raises without it)."""

    def __init__(self, text_tokenizer, data_list: Optional[str],
                 spk_emb_fn: Optional[Callable[[np.ndarray], np.ndarray]]
                 = None, add_task_token: bool = True,
                 add_speaker_id: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.text_tokenizer = text_tokenizer
        self.spk_emb_fn = spk_emb_fn
        self.add_task_token = add_task_token
        self.add_speaker_id = add_speaker_id
        self.datas: List[Dict[str, Any]] = []
        if data_list is not None:
            self._load(data_list)

    def _load(self, data_list: str):
        missing = 0
        with open(data_list, "r", encoding="utf-8") as f:
            lines = f.readlines()
        for line in lines:
            data = json.loads(line.strip())
            valid = all(data.get(k) is not None
                        for k in ["key", "prompt_text", "text", "prompt_wav"])
            if valid:
                valid = all(os.path.exists(u) for u in data["prompt_wav"])
            if valid:
                self.datas.append(data)
            else:
                missing += 1
        print(f"Loaded {len(lines)} lines, {missing} missing, "
              f"{len(self.datas)} valid.")

    def update_datasource(self, data_list: List[Dict[str, Any]]):
        """In-memory datasource (PodcastInferHandler, dataloader.py:252-295)."""
        self.datas = data_list

    def __len__(self):
        return len(self.datas)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    def _speaker_embedding(self, audio16k: np.ndarray) -> List[float]:
        feat = fbank(audio16k, num_mel_bins=80, sr=16000, dither=0.0)
        feat = feat - feat.mean(axis=0, keepdims=True)
        if self.spk_emb_fn is None:
            raise RuntimeError(
                "no speaker-embedding backend: pass spk_emb_fn (e.g. "
                "make_onnx_spk_emb_fn(model_dir)) to PodcastDataset")
        return np.asarray(self.spk_emb_fn(feat), np.float32).flatten().tolist()

    def _prompt_text_ids(self, text: str, spk_idx: int) -> List[int]:
        speaker = SPK_DICT[spk_idx] if self.add_speaker_id else ""
        text = normalize_text(text)
        text = f"{speaker}{TEXT_START}{text}{TEXT_END}{AUDIO_START}"
        if spk_idx == 0 and self.add_task_token:
            text = f"{TASK_PODCAST}{text}"
        return self.text_tokenizer.encode(text)

    def __getitem__(self, idx: int) -> Optional[Dict[str, Any]]:
        data = self.datas[idx]
        try:
            item = self.build_item(data)
        except Exception as e:  # skip broken rows like the reference
            print(f"[WARNING] Error processing data item "
                  f"{data.get('key', idx)}: {e}")
            return None
        return item

    def build_item(self, data: Dict[str, Any]) -> Dict[str, Any]:
        prompt_text_ids_list = []
        dialect_prompt_text_ids_list = []
        dialect_prefix_list = []
        spk_emb_list, mel_list, mel_len_list, log_mel_list = [], [], [], []
        use_dialect_prompt = "dialect_prompt_text" in data

        if self.add_task_token:
            dialect_prefix_list.append(
                self.text_tokenizer.encode(TASK_PODCAST))

        for spk_idx, (prompt_text, prompt_wav) in enumerate(
                zip(data["prompt_text"], data["prompt_wav"])):
            raw, sr = load_wav(prompt_wav)
            audio16 = resample(raw, sr, 16000) if sr != 16000 else raw
            audio16 = audio_volume_normalize(audio16)
            log_mel = log_mel_spectrogram(self._t(audio16)).cpu().numpy()

            spk_emb_list.append(self._speaker_embedding(audio16))

            audio24 = audio_volume_normalize(
                resample(raw, sr, 24000) if sr != 24000 else raw)
            mel = mel_spectrogram(self._t(audio24[None]))[0].T  # [T, 80]
            mel = mel.cpu().numpy()
            if mel.shape[0] % 2 != 0:
                mel = mel[:-1]
            mel_list.append(mel)
            mel_len_list.append(mel.shape[0])
            log_mel_list.append(log_mel)

            prompt_text_ids_list.append(
                self._prompt_text_ids(prompt_text, spk_idx))
            if use_dialect_prompt:
                speaker = SPK_DICT[spk_idx] if self.add_speaker_id else ""
                d_text = normalize_text(data["dialect_prompt_text"][spk_idx])
                d_text = f"{speaker}{TEXT_START}{d_text}{TEXT_END}{AUDIO_START}"
                dialect_prompt_text_ids_list.append(
                    self.text_tokenizer.encode(d_text))
                dialect_prefix_list.append(
                    self.text_tokenizer.encode(TASK_PODCAST)
                    if (spk_idx == 0 and self.add_task_token) else [])

        item: Dict[str, Any] = {
            "prompt_text_tokens": prompt_text_ids_list,
            "spk_emb": spk_emb_list,
            "mel": mel_list,
            "mel_len": mel_len_list,
            "log_mel": log_mel_list,
            "info": data,
        }
        if use_dialect_prompt:
            item.update({
                "use_dialect_prompt": True,
                "dialect_prompt_text_tokens": dialect_prompt_text_ids_list,
                "dialect_prefix": dialect_prefix_list,
            })

        text_ids_list, spks_list = [], []
        spks = data.get("spk", [0] * len(data["text"]))
        for text, spk in zip(data["text"], spks):
            speaker = SPK_DICT[spk] if self.add_speaker_id else ""
            text = normalize_text(text)
            text = f"{speaker}{TEXT_START}{text}{TEXT_END}{AUDIO_START}"
            text_ids_list.append(self.text_tokenizer.encode(text))
            spks_list.append(spk)
        item.update({"text_tokens": text_ids_list, "spks_list": spks_list})
        return item


PodcastInferHandler = PodcastDataset
