"""The port as a package: what it imports, where it runs, how its kernels
are built and counted."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import neural_compressor_tpu_torch as nct
from neural_compressor_tpu_torch import kernels
from neural_compressor_tpu_torch.common import config as tconfig
from neural_compressor_tpu_torch.kernels import _build
from neural_compressor_tpu_torch.models import llama as tl

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "neural_compressor_tpu_torch"
FORBIDDEN = ("jax", "flax", "neural_compressor_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("root", ["package", "chip_smoke.py"])
def test_no_jax_import_anywhere_in_the_port(root):
    files = (sorted(PORT.rglob("*.py")) if root == "package"
             else [REPO / "chip_smoke.py"])
    assert files
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if _forbidden(m)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, neural_compressor_tpu_torch, "
            "neural_compressor_tpu_torch.kernels, "
            "neural_compressor_tpu_torch.generation\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\nprint(repr(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_device_none_means_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tl.LlamaConfig(**tl.LLAMA_PRESETS["llama-test"])
    calls = [lambda: nct.common.resolve_device(None),
             lambda: tl.LlamaForCausalLM(cfg),
             lambda: tl.init_kv_cache(cfg, 1, 8),
             lambda: nct.build_quantized(cfg, nct.RTNConfig()),
             lambda: nct.from_jax_params({}, cfg)]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert nct.common.resolve_device("cpu") == torch.device("cpu")


def test_each_kernel_wrapper_counts_its_launches():
    names = [fn.__name__ for fn in kernels.KERNEL_WRAPPERS]
    assert names == ["w4a8_gemm", "fused_gemv", "decode_attn",
                     "batched_decode_attn", "paged_attn", "paged_write",
                     "dequant_gemm", "vpu_gemv"]
    for fn in kernels.KERNEL_WRAPPERS:
        assert isinstance(fn.launches, int)
        fn.launches += 3
    kernels.reset_launch_counts()
    assert all(fn.launches == 0 for fn in kernels.KERNEL_WRAPPERS)


def test_every_kernel_has_a_source_and_a_c_entry():
    sources = {p.name for p in _build.CSRC.glob("*.cu")}
    assert sources == {"w4a8_gemm.cu", "fused_gemv.cu", "decode_attention.cu",
                       "batched_decode_attention.cu", "paged_attention.cu",
                       "paged_write.cu", "dequant_matmul.cu"}
    text = "".join((_build.CSRC / s).read_text() for s in sources)
    for entry in _build.SIGNATURES:
        assert f"NCTT_API int {entry}(" in text
    for s in sources:  # each source names the TPU kernel it replaces
        assert "Replaces: neural_compressor_tpu/kernels/" in \
            (_build.CSRC / s).read_text()


def _fake_nvcc(tmp_path, monkeypatch, stderr="error: nvcc says no"):
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho '{stderr}' >&2\nexit 3\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)


def test_failed_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match="nvcc says no"):
        _build.library()
    # nothing half-built is left to be loaded later
    assert not list((tmp_path / "build").glob("*/" + _build.LIB_NAME))


def test_non_cpu_tensors_never_fall_back_to_the_plain_version(tmp_path,
                                                              monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch)
    meta = torch.device("meta")
    xq = torch.empty(4, 256, dtype=torch.int8, device=meta)
    w = torch.empty(256, 128, dtype=torch.uint8, device=meta)
    sc = torch.empty(2, 256, dtype=torch.float32, device=meta)
    xs = torch.empty(4, dtype=torch.float32, device=meta)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.w4a8_gemm(xq, w, sc, xs)
    x = torch.empty(256, dtype=torch.bfloat16, device=meta)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.fused_gemv(x, None, w, sc, None, None, eps=0.0, silu=False,
                           out_dtype=torch.bfloat16)
    q = torch.empty(1, 4, 64, dtype=torch.bfloat16, device=meta)
    kv = torch.empty(1, 4, 16, 64, dtype=torch.bfloat16, device=meta)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.decode_attn(q, kv, kv, 3)
    xb = torch.empty(4, 256, dtype=torch.bfloat16, device=meta)
    wq = torch.empty(32, 128, dtype=torch.int32, device=meta)
    sc2 = torch.empty(2, 128, dtype=torch.float32, device=meta)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.dequant_gemm(xb, wq, sc2, None, None, bits=4, group_size=128,
                             layout="tpu_strided", out_dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.vpu_gemv(xb[0], wq, sc2, sc2, bits=4, group_size=128,
                         out_dtype=torch.bfloat16)


def test_wrappers_check_their_operands():
    meta = torch.device("meta")
    xq = torch.empty(4, 250, dtype=torch.int8, device=meta)
    with pytest.raises(ValueError, match="K % 32"):
        kernels.w4a8_gemm(xq, torch.empty(256, 125, dtype=torch.uint8,
                                          device=meta),
                          torch.empty(2, 256, device=meta),
                          torch.empty(4, device=meta))
    q = torch.empty(1, 4, 48, dtype=torch.bfloat16, device=meta)
    kv = torch.empty(1, 4, 16, 48, dtype=torch.bfloat16, device=meta)
    with pytest.raises(ValueError, match="D in"):
        kernels.decode_attn(q, kv, kv, 3)
    xb = torch.empty(4, 256, dtype=torch.bfloat16, device=meta)
    with pytest.raises(ValueError, match="N % 128"):
        kernels.dequant_gemm(xb, torch.empty(32, 96, dtype=torch.int32,
                                             device=meta),
                             torch.empty(2, 96, device=meta), None, None,
                             bits=4, group_size=128, layout="tpu_strided",
                             out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 activations"):
        kernels.dequant_gemm(xb.float(), None, torch.empty(2, 128,
                                                           device=meta),
                             None, None, bits=4, group_size=128,
                             layout="tpu_strided", out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int2/int4"):
        kernels.vpu_gemv(xb[0], torch.empty(256, 128, dtype=torch.int8,
                                            device=meta),
                         torch.empty(2, 128, device=meta), None, bits=8,
                         group_size=128, out_dtype=torch.bfloat16)


def test_digest_follows_the_sources(tmp_path, monkeypatch):
    d0 = _build.digest()
    assert d0 == _build.digest() and len(d0) == 16
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _build.CSRC.glob("*.cu*"):
        (src / p.name).write_text(p.read_text())
    monkeypatch.setattr(_build, "CSRC", src)
    assert _build.digest() == d0
    (src / "w4a8_gemm.cu").write_text("// edited\n")
    assert _build.digest() != d0


def test_config_mapping_matches_the_jax_package():
    from neural_compressor_tpu.quantization.config import RTNConfig as JRTN

    info = [("model.layers.0.self_attn.q_proj", "Linear"),
            ("model.layers.1.mlp.up_proj", "Linear"),
            ("model.layers.10.mlp.up_proj", "Linear"),
            ("lm_head", "Linear"), ("model.norm", "RMSNorm")]
    for kw in (dict(), dict(quant_lm_head=True),
               dict(white_list=["layers.1"])):
        tmap = nct.RTNConfig(**kw).to_config_mapping(info)
        jmap = JRTN(**kw).to_config_mapping(info)
        assert sorted(tmap) == sorted(jmap)
    local = nct.RTNConfig(group_size=128, quant_lm_head=True).set_local(
        "lm_head", nct.RTNConfig(dtype="fp32"))
    assert local.to_config_mapping(info)[("lm_head", "Linear")].dtype == "fp32"
    assert isinstance(nct.RTNConfig(), tconfig.BaseConfig)
    assert tconfig.config_registry.get_config_cls_by_name("rtn") is \
        nct.RTNConfig
