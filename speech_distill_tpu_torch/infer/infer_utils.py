"""Inference glue: model construction and request preprocessing (port of
``speech_distill_tpu/infer/infer_utils.py``; reference
soulxpodcast/utils/infer_utils.py:16-161)."""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import numpy as np

from speech_distill_tpu_torch.core.config import (EngineConfig, Qwen3Config,
                                                  SamplingParams)
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.utils.commons import set_all_random_seed

LLM_ENGINES = ("jax", "paged")
KV_CACHE_DTYPES = ("bf16", "int8")


def pad_log_mels(log_mels: List[np.ndarray]):
    """[n_mels, T_i] list -> ([B, n_mels, T_max], lens), like
    s3tokenizer.padding."""
    T = max(m.shape[-1] for m in log_mels)
    out = np.zeros((len(log_mels), log_mels[0].shape[0], T), np.float32)
    lens = np.zeros((len(log_mels),), np.int32)
    for i, m in enumerate(log_mels):
        out[i, :, :m.shape[-1]] = m
        lens[i] = m.shape[-1]
    return out, lens


def pad_mels(mels: List[np.ndarray]):
    """[T_i, 80] list -> [B, T_max, 80] zero-padded."""
    T = max(m.shape[0] for m in mels)
    out = np.zeros((len(mels), T, mels[0].shape[1]), np.float32)
    for i, m in enumerate(mels):
        out[i, :m.shape[0]] = m
    return out


def _read(path: str):
    import torch
    return torch.load(path, map_location="cpu", weights_only=True)


def initiate_model(seed: int, model_path: str, llm_engine: str = "jax",
                   fp16_flow: bool = False, add_task_token: bool = True,
                   add_speaker_id: bool = True, spk_emb_fn=None,
                   kv_cache_dtype: str = "bf16", device="cuda"):
    """(SoulXPodcast model, PodcastInferHandler dataset) on ``device``
    (CUDA by default; raises without it).

    Reads ``soulxpodcast_config.json``, the HF LLM directory
    (``config.json``, safetensors, the tokenizer), ``flow.pt``,
    ``hift.pt``, ``speech_tokenizer_v2.pt`` (else ``$S3_TOKENIZER_CKPT``)
    and ``campplus.pt``, falling back to ``campplus.onnx`` through
    onnxruntime when there is no ``campplus.pt``
    (reference infer_utils.py:16-44). ``llm_engine``: "jax" (the stateful
    contiguous-cache ``DecodeEngine``, under the JAX flag's name) or
    "paged" (the stateless ``PagedEngine`` with prefix caching, the vLLM
    role); ``kv_cache_dtype``: "bf16" or "int8" (the paged engine's pool).
    ``fp16_flow`` is accepted and ignored, as in JAX: the flow runs in
    fp32."""
    import torch
    from transformers import AutoTokenizer

    from speech_distill_tpu_torch.infer.dataloader import (
        PodcastInferHandler, make_onnx_spk_emb_fn)
    from speech_distill_tpu_torch.infer.soulxpodcast import SoulXPodcast
    from speech_distill_tpu_torch.models import campplus
    from speech_distill_tpu_torch.models import flow as flow_lib
    from speech_distill_tpu_torch.models import hift as hift_lib
    from speech_distill_tpu_torch.models.convert import load_reference_state
    from speech_distill_tpu_torch.models.hf_loader import load_pretrained
    from speech_distill_tpu_torch.tokenizer import s3

    dev = resolve_device(device)
    if llm_engine not in LLM_ENGINES:
        raise ValueError(f"llm_engine must be one of {LLM_ENGINES}, got "
                         f"{llm_engine!r}")
    if kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype must be one of {KV_CACHE_DTYPES}, "
                         f"got {kv_cache_dtype!r}")
    set_all_random_seed(seed)

    llm_cfg = Qwen3Config.from_initial_and_json(
        json_file=os.path.join(model_path, "soulxpodcast_config.json"))
    config = EngineConfig(model=model_path, llm=llm_cfg)

    tokenizer = AutoTokenizer.from_pretrained(model_path, use_fast=True)
    _, llm = load_pretrained(model_path, device=dev)
    if llm_engine == "paged":
        from speech_distill_tpu_torch.infer.paged import PagedEngine
        engine = PagedEngine(
            llm, llm_cfg, config.sampling, max_len=config.max_model_len,
            seed=seed, device=dev,
            cache_dtype=(torch.int8 if kv_cache_dtype == "int8"
                         else torch.bfloat16))
    else:
        from speech_distill_tpu_torch.infer.engine import DecodeEngine
        engine = DecodeEngine(llm, llm_cfg, config.sampling,
                              max_len=config.max_model_len, seed=seed,
                              device=dev)

    flow_cfg = flow_lib.FlowConfig()
    flow = load_reference_state(flow_lib.Flow(flow_cfg, dev),
                                _read(os.path.join(model_path, "flow.pt")))
    hift_cfg = hift_lib.HiFTConfig()
    hift_state = {k.replace("generator.", ""): v for k, v in _read(
        os.path.join(model_path, "hift.pt")).items()}
    hift = load_reference_state(hift_lib.HiFTGenerator(hift_cfg, dev),
                                hift_lib.fold_weight_norm(hift_state))

    s3_path = os.path.join(model_path, "speech_tokenizer_v2.pt")
    tok = s3.load_s3_tokenizer(s3_path if os.path.exists(s3_path) else None,
                               device=dev)

    def s3_quantize(mels, lens):
        return s3.quantize(tok.model, mels, lens)

    model = SoulXPodcast(config, engine, s3_quantize, flow, flow_cfg, hift,
                         hift_cfg, seed=seed, device=dev)

    if spk_emb_fn is None:
        # CAM++ from a torch state dict named campplus.pt; else the
        # reference's onnxruntime path over campplus.onnx
        camp_pt = os.path.join(model_path, "campplus.pt")
        if os.path.exists(camp_pt):
            spk_emb_fn = campplus.make_spk_emb_fn(
                campplus.from_state_dict(_read(camp_pt),
                                         campplus.CampPlusConfig(), dev),
                dev)
        else:
            try:
                spk_emb_fn = make_onnx_spk_emb_fn(model_path)
            except ImportError:
                spk_emb_fn = None
    dataset = PodcastInferHandler(tokenizer, None, spk_emb_fn=spk_emb_fn,
                                  add_task_token=add_task_token,
                                  add_speaker_id=add_speaker_id, device=dev)
    return model, dataset


def _assemble(data: Dict[str, Any],
              use_dialect_prompt: Optional[bool] = None) -> Dict[str, Any]:
    mels, lens = pad_log_mels(data["log_mel"])
    out = {
        "prompt_mels_for_llm": mels,
        "prompt_mels_lens_for_llm": lens,
        "prompt_text_tokens_for_llm": data["prompt_text_tokens"],
        "text_tokens_for_llm": data["text_tokens"],
        "prompt_mels_for_flow_ori": pad_mels(data["mel"]),
        "prompt_mels_lens_for_flow": np.asarray(data["mel_len"], np.int32),
        "spk_emb_for_flow": np.asarray(data["spk_emb"], np.float32),
        "sampling_params": SamplingParams(use_ras=True, win_size=25,
                                          tau_r=0.2),
        "spk_ids": data["spks_list"],
        "infos": [data["info"]],
    }
    if use_dialect_prompt is not None:
        out["use_dialect_prompt"] = use_dialect_prompt
        if use_dialect_prompt:
            out["dialect_prompt_text_tokens_for_llm"] = \
                data["dialect_prompt_text_tokens"]
            out["dialect_prefix"] = data["dialect_prefix"]
    return out


def process_single_tts_input(dataset, texts, prompt_wav_list,
                             prompt_text_list) -> Dict[str, Any]:
    dataset.update_datasource([{
        "key": "001", "prompt_text": prompt_text_list,
        "prompt_wav": prompt_wav_list, "text": texts}])
    return _assemble(dataset[0])


def process_single_input(dataset, target_text_list, prompt_wav_list,
                         prompt_text_list, use_dialect_prompt,
                         dialect_prompt_text_list) -> Dict[str, Any]:
    """Regex-split ``[S1]``-tagged dialogue lines (infer_utils.py:88-152)."""
    spks, texts = [], []
    for target_text in target_text_list:
        match = re.match(r"(\[S[1-9]\])(.+)", target_text)
        texts.append(match.group(2))
        spks.append(int(match.group(1)[2]) - 1)
    item = {"key": "001", "prompt_text": prompt_text_list,
            "prompt_wav": prompt_wav_list, "text": texts, "spk": spks}
    if use_dialect_prompt:
        item["dialect_prompt_text"] = dialect_prompt_text_list
    dataset.update_datasource([item])
    return _assemble(dataset[0], use_dialect_prompt)


def check_models(model_path: str, inputs: Dict[str, Any]) -> bool:
    if inputs.get("use_dialect_prompt") and "dialect" not in model_path:
        raise ValueError("Dialect prompt is used, you should use a dialect "
                         "model.")
    return True
