"""PyTorch port, guards: the port runs without JAX, imports nothing of the
JAX package, and its entry points refuse to run on the CPU unless asked."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "speech_distill_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {_modules()!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'speech_distill_tpu' or "
            "k.startswith('speech_distill_tpu.') for k in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    def banned(name):
        return (name == "jax" or name.startswith("jax.")
                or name == "speech_distill_tpu"
                or name.startswith("speech_distill_tpu."))

    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(banned(n) for n in names), (path, names)


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from speech_distill_tpu_torch.core.config import (DistillConfig,
                                                      LoraConfig,
                                                      SamplingParams,
                                                      qwen3_tiny)
    from speech_distill_tpu_torch.core.trainer import LoopConfig, train_loop
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.distill.lora import init_lora
    from speech_distill_tpu_torch.infer.paged import PagedEngine
    from speech_distill_tpu_torch.models import qwen3

    cfg = qwen3_tiny(32, dtype="float32")
    model = qwen3.init_params(cfg, seed=0, device="cpu")
    ids = np.ones((1, 4), np.int64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedEngine(model, cfg, SamplingParams())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        qwen3.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        qwen3.forward_train(model, ids)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_lora(model, cfg, LoraConfig(r=2, alpha=4))
    opt = train_step.make_optimizer(1e-3, 1, 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_step.make_kd_step(cfg, DistillConfig(), opt,
                                mode="precomputed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_step.make_stage1_step(cfg, opt, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_step.make_stage1_eval_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_loop(lambda *a: None, None, (), lambda epoch: iter(()),
                   LoopConfig(output_dir=str(tmp_path)))
    _tts_entry_points_raise()
    _audio_entry_points_raise(tmp_path)
    _cli_mains_raise(tmp_path)
    # the explicit CPU request runs
    eng = PagedEngine(model, cfg, SamplingParams(top_k=4,
                                                 stop_token_ids=(31,)),
                      slots=2, max_len=32, page_size=8, device="cpu")
    out = eng.serve([np.arange(1, 6).tolist()], max_new=3)
    assert len(out[0]) == 3


def _cli_mains_raise(tmp_path):
    """Every CLI ``main`` with CUDA reported missing and no ``--device
    cpu`` (it raises before it reads its paths)."""
    from speech_distill_tpu_torch.pipelines import (evaluate,
                                                    extract_logits,
                                                    prepare_dataset,
                                                    prepare_student, stage1,
                                                    synthesize, train)
    d = str(tmp_path / "missing")
    calls = [
        lambda: prepare_student.main(["--teacher-model", d,
                                      "--student-model", d,
                                      "--output-dir", d]),
        lambda: prepare_dataset.main(["--dataset_path", d,
                                      "--output_path", d]),
        lambda: extract_logits.main(["--teacher_model_path", d,
                                     "--dataset_path", d,
                                     "--output_path", d]),
        lambda: stage1.main(["--model_path", d, "--dataset_path", d,
                             "--output_dir", str(tmp_path / "s1")]),
        lambda: train.main(["--dataset_path", d]),
        lambda: evaluate.main(["--student_model", d, "--dataset_path", d]),
        lambda: synthesize.main(["--model_path", d, "--script", d])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def _audio_entry_points_raise(tmp_path):
    """The audio prompt path's entry points (the S3 tokenizer, CAM++, the
    inference dataset, the orchestrator and ``initiate_model``) with
    CUDA reported missing; CAM++'s spk_emb_fn runs on the CPU when
    asked."""
    from speech_distill_tpu_torch.core.config import EngineConfig
    from speech_distill_tpu_torch.infer.dataloader import PodcastDataset
    from speech_distill_tpu_torch.infer.infer_utils import initiate_model
    from speech_distill_tpu_torch.infer.soulxpodcast import SoulXPodcast
    from speech_distill_tpu_torch.models import campplus
    from speech_distill_tpu_torch.tokenizer import s3

    tiny = campplus.CampPlusConfig(block_layers=(1, 1, 1))
    cpu_model = campplus.CAMPPlus(tiny, "cpu")
    ckpt = tmp_path / "s3.pt"
    torch.save(s3.S3Encoder(s3.s3_tiny(), "cpu").state_dict(), ckpt)
    raising = [
        lambda: s3.load_s3_tokenizer(str(ckpt)),
        lambda: s3.S3Encoder(s3.s3_tiny()),
        lambda: s3.init_params_on_device(0, s3.s3_tiny()),
        lambda: s3.default_speech_tokens_fn()(np.zeros(1600, np.float32)),
        lambda: campplus.CAMPPlus(tiny),
        lambda: campplus.make_spk_emb_fn(cpu_model),
        lambda: PodcastDataset(None, None),
        lambda: SoulXPodcast(EngineConfig(), None, None, None, None, None,
                             None),
        lambda: initiate_model(0, str(tmp_path / "missing"))]
    for make in raising:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    emb = campplus.make_spk_emb_fn(cpu_model, "cpu")(
        np.zeros((40, 80), np.float32))
    assert emb.shape == (192,)


def _tts_entry_points_raise():
    """The TTS tail's entry points (models, weight carry-over, the
    incremental cache, the synthesizer and the coordinator) with CUDA
    reported missing."""
    from speech_distill_tpu_torch.infer.streaming_tts import (
        StreamingTokenToWav)
    from speech_distill_tpu_torch.infer.tts_serve import MultiSessionTTS
    from speech_distill_tpu_torch.models import flow, hift
    from speech_distill_tpu_torch.models.convert import (
        flow_params_from_jax, hift_params_from_jax)
    from speech_distill_tpu_torch.models.flow_encoder import (
        FlowEncoderConfig)

    fc = flow.FlowConfig(
        input_size=8, output_size=4, spk_embed_dim=3, vocab_size=10,
        n_timesteps=1, est_in_channels=16, est_channels=8, est_n_blocks=1,
        est_num_mid_blocks=1, est_num_heads=1, est_head_dim=4,
        static_chunk_size=4, encoder=FlowEncoderConfig(
            input_size=8, output_size=8, attention_heads=1, linear_units=8,
            num_blocks=1, num_up_blocks=1, static_chunk_size=2))
    hc = hift.HiFTConfig(in_channels=4, base_channels=8, nb_harmonics=1,
                         resblock_kernel_sizes=(3,),
                         resblock_dilations=((1,),),
                         source_resblock_kernel_sizes=(3, 3, 3),
                         source_resblock_dilations=((1,), (1,), (1,)),
                         f0_cond_channels=4)
    fm, hm = flow.init_params(fc, 0, "cpu"), hift.init_params(hc, 0, "cpu")
    raising = [
        lambda: flow.init_params(fc, 0),
        lambda: hift.init_params(hc, 0),
        lambda: flow_params_from_jax(flow.numpy_init_tree(fc), fc),
        lambda: hift_params_from_jax(hift.numpy_init_tree(hc), hc),
        lambda: flow.init_incremental_cache(fc, 1, 8),
        lambda: StreamingTokenToWav(fm, fc, hm, hc, [1],
                                    np.zeros((2, 4), np.float32), 2,
                                    np.ones(3, np.float32), 0),
        lambda: MultiSessionTTS(None, fm, fc, hm, hc, 0)]
    for make in raising:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # on the CPU when asked
    StreamingTokenToWav(fm, fc, hm, hc, [1], np.zeros((2, 4), np.float32),
                        2, np.ones(3, np.float32), 0, device="cpu")


def test_decode_engines_raise_without_cuda(monkeypatch):
    """DecodeEngine, ContinuousEngine and the stream_tts path default to
    the card; asked for the CPU, they run."""
    from speech_distill_tpu_torch.core.config import (SamplingParams,
                                                      qwen3_tiny)
    from speech_distill_tpu_torch.infer.continuous import ContinuousEngine
    from speech_distill_tpu_torch.infer.engine import DecodeEngine
    from speech_distill_tpu_torch.infer.streaming_tts import stream_tts
    from speech_distill_tpu_torch.models import qwen3

    cfg = qwen3_tiny(32, dtype="float32")
    model = qwen3.init_params(cfg, seed=0, device="cpu")
    sp = SamplingParams(top_k=4, stop_token_ids=(31,), max_tokens=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (DecodeEngine, ContinuousEngine):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(model, cfg, sp)
    eng = DecodeEngine(model, cfg, sp, max_len=32, prefill_bucket=8,
                       device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(stream_tts(eng, None, None, None, None, [1, 2], 0, [1],
                        np.zeros((2, 4), np.float32), 2,
                        np.ones(3, np.float32), 0))
    assert len(eng.generate([1, 2, 3])["token_ids"]) == 3
    ceng = ContinuousEngine(model, cfg, sp, slots=2, max_len=32,
                            prefill_bucket=8, device="cpu")
    assert [len(o) for o in ceng.serve([[1, 2], [3]])] == [3, 3]


def test_lm_head_kernel_wrappers_refuse_what_the_kernels_cannot_take():
    """On the card the K2 wrappers launch or raise; the checks before the
    launch run anywhere (the CPU has no kernel to reach)."""
    from speech_distill_tpu_torch.ops import pallas_lm_loss as pl
    h = torch.zeros(4, 96, dtype=torch.bfloat16)
    w = torch.zeros(10, 96, dtype=torch.bfloat16)
    labels = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="D in"):
        pl.lm_head_stats_kernel(h, w, labels, 2.0)
    with pytest.raises(ValueError, match="bf16"):
        pl.lm_head_stats_kernel(h.float()[:, :64], w.float()[:, :64],
                                labels, 2.0)
    h64, w64 = h[:, :64].contiguous(), w[:, :64].contiguous()
    with pytest.raises(ValueError, match="int32"):
        pl.lm_head_dh(h64, w64, labels.long(), *[torch.zeros(4)] * 5, 2.0)


def test_quantized_serving_raises_without_cuda(monkeypatch):
    """The int8 pool and the quantized model default to the card too."""
    from speech_distill_tpu_torch.core.config import qwen3_tiny
    from speech_distill_tpu_torch.infer.paged import PagedKVCache
    from speech_distill_tpu_torch.models import qwen3
    from speech_distill_tpu_torch.models.convert import (model_to_tree,
                                                         params_from_jax)
    from speech_distill_tpu_torch.ops.quant import quantize_params

    cfg = qwen3_tiny(32, dtype="float32")
    tree = quantize_params(model_to_tree(qwen3.init_params(cfg, 0, "cpu")),
                           bits=4, method="int4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVCache.create(cfg, 4, 8, torch.int8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(tree, cfg)
    model = params_from_jax(tree, cfg, "cpu")
    assert isinstance(model.layers[0].attn.q, qwen3.QuantWeight)


def test_cosyvoice2_entry_points_raise_without_cuda(monkeypatch):
    """The CosyVoice2 teacher's entry points (the model, both inits, the
    torch-checkpoint and JAX-tree conversions) with CUDA reported
    missing; the 8-bit and fused optimizers, device-agnostic like the
    default one, run on the CPU tensors they are given."""
    from speech_distill_tpu_torch.core.config import qwen3_tiny
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.models import cosyvoice2 as cv2
    from speech_distill_tpu_torch.models.convert import (
        cosyvoice2_params_from_jax, model_to_tree)

    cfg = cv2.CosyVoice2Config(
        backbone=qwen3_tiny(40, dtype="float32", attention_bias=True,
                            qk_norm=False),
        text_vocab_size=40, speech_token_size=4, unified_vocab_size=50)
    cpu = cv2.init_params(cfg, 0, "cpu")
    state = cv2.torch_state(cpu)
    tree = {"backbone": model_to_tree(cpu.backbone),
            "llm_embedding": cpu.llm_embedding,
            "speech_embedding": cpu.speech_embedding,
            "llm_decoder": {"w": cpu.llm_decoder.w, "b": cpu.llm_decoder.b}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raising = [lambda: cv2.CosyVoice2(cfg),
               lambda: cv2.init_params(cfg, 0),
               lambda: cv2.init_params_on_device(0, cfg),
               lambda: cv2.convert_torch_state(state, cfg),
               lambda: cosyvoice2_params_from_jax(tree, cfg)]
    for make in raising:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    params = {"w": torch.ones(3, 300)}
    for kw in ({"eight_bit": True}, {"fused": True}):
        opt = train_step.make_optimizer(1e-3, 1, 4, **kw)
        ups, _ = opt.update({"w": torch.ones(3, 300)}, opt.init(params),
                            params)
        assert ups["w"].device.type == "cpu"


def test_parallel_entry_points_take_the_rank_card(monkeypatch, tmp_path):
    """The parallel layer's entry points: a rank's device is
    ``cuda:LOCAL_RANK`` unless ``device="cpu"`` is passed, and they raise
    without CUDA before any process group or child is started."""
    from speech_distill_tpu_torch.parallel import mesh as meshlib
    from speech_distill_tpu_torch.parallel import multihost
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert meshlib.rank_device() == torch.device("cuda", 3)
    assert meshlib.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (meshlib.rank_device, meshlib.make_mesh,
                 meshlib.single_device_mesh,
                 lambda: multihost.initialize("localhost:1", 2, 0),
                 lambda: multihost.launch(print, 2,
                                          store_dir=str(tmp_path))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert meshlib.make_mesh(device="cpu").device == torch.device("cpu")
    assert meshlib.single_device_mesh("cpu").world == 1
