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
    """One wrapper per C entry; the kernels that take several cache
    formats count their launches per format."""
    names = [fn.__name__ for fn in kernels.KERNEL_WRAPPERS]
    assert names == ["w4a8_gemm", "fused_gemv", "decode_attn",
                     "decode_attn_quant", "batched_decode_attn",
                     "paged_attn", "paged_write", "dequant_gemm", "vpu_gemv",
                     "paged_write_window_kernel", "paged_window_attn",
                     "paged_attn_gemma", "paged_latent_write",
                     "paged_latent_attn", "paged_attn_v1",
                     "decode_attn_write", "decode_attn_hbm", "omlp",
                     "attn_o", "w4a8_gemm_strided", "s4_gemm",
                     "vpu_int8act"]
    pools = ["bf16", "int8", "fp8_e4m3", "int4"]
    by_format = {"batched_decode_attn": ["bf16", "int8", "fp8_e4m3"],
                 "paged_attn": pools, "paged_write": pools,
                 "paged_write_window_kernel": pools,
                 "paged_window_attn": pools,
                 # K11's gemma branches: the band (with or without the
                 # softcap) and the softcap alone, per pool format
                 "paged_attn_gemma": [f"{b}_{f}" for b in ("band", "softcap")
                                      for f in pools],
                 # the flag-selected variants: K15 (v1 paged, no int4) and
                 # K16's in-kernel write (bf16 and int8 caches)
                 "paged_attn_v1": pools[:3],
                 "decode_attn_write": pools[:2]}
    for fn in kernels.KERNEL_WRAPPERS:
        if fn.__name__ in by_format:
            assert list(fn.launches) == by_format[fn.__name__]
            fn.launches[by_format[fn.__name__][1]] += 3
        else:
            assert isinstance(fn.launches, int)
            fn.launches += 3
    kernels.reset_launch_counts()
    assert all(sum(fn.launches.values()) == 0 if isinstance(fn.launches, dict)
               else fn.launches == 0 for fn in kernels.KERNEL_WRAPPERS)


def test_every_kernel_has_a_source_and_a_c_entry():
    sources = {p.name for p in _build.CSRC.glob("*.cu")}
    assert sources == {"w4a8_gemm.cu", "w4a8_gemm_strided.cu",
                       "fused_gemv.cu", "decode_attention.cu",
                       "decode_split.cu", "decode_split_int8.cu",
                       "decode_split_fp8.cu", "decode_split_k5.cu",
                       "paged_attention.cu",
                       "paged_attention_fp8_int4.cu", "paged_write.cu", "dequant_matmul.cu",
                       "paged_latent.cu", "paged_attention_v1.cu",
                       "decode_attention_hbm.cu", "omlp.cu", "attn_o.cu",
                       "s4_gemm.cu", "vpu_int8act.cu"}
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
    # K1 on tpu_strided words, K2 on s4_rowpack words, K10
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.w4a8_gemm_strided(xq, torch.empty(32, 256, dtype=torch.int32,
                                                  device=meta), sc, xs)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.s4_gemm(xq, torch.empty(256, 32, dtype=torch.int32,
                                        device=meta), sc, xs)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.vpu_int8act(xb[0], wq, sc2, None, bits=4, group_size=128,
                            tk=256, out_dtype=torch.bfloat16)
    lat = torch.empty(5, 1, 8, 24, dtype=torch.bfloat16, device=meta)
    bt = torch.empty(2, 2, dtype=torch.int32, device=meta)
    n = torch.empty(2, dtype=torch.int32, device=meta)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.paged_latent_write(torch.empty(2, 24, dtype=torch.bfloat16,
                                               device=meta), lat, bt, n)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.paged_latent_attn(torch.empty(2, 4, 24, dtype=torch.bfloat16,
                                              device=meta), lat, bt, n, 16,
                                  0.1)


def test_wrappers_check_their_operands():
    meta = torch.device("meta")
    # any group size since the repair, but K a multiple of it (250 is not
    # of 250 // 3)
    xq = torch.empty(4, 250, dtype=torch.int8, device=meta)
    with pytest.raises(ValueError, match="multiple of the group size"):
        kernels.w4a8_gemm(xq, torch.empty(256, 125, dtype=torch.uint8,
                                          device=meta),
                          torch.empty(3, 256, device=meta),
                          torch.empty(4, device=meta))
    # any head width up to 256 since the repair
    q = torch.empty(1, 4, 300, dtype=torch.bfloat16, device=meta)
    kv = torch.empty(1, 4, 16, 300, dtype=torch.bfloat16, device=meta)
    with pytest.raises(ValueError, match="D <= 256"):
        kernels.decode_attn(q, kv, kv, 3)
    lat = torch.empty(4, 1, 8, 24, dtype=torch.bfloat16, device=meta)
    with pytest.raises(ValueError, match="r <= C"):
        kernels.paged_latent_attn(torch.empty(1, 4, 24, dtype=torch.bfloat16,
                                              device=meta), lat,
                                  torch.empty(1, 2, dtype=torch.int32,
                                              device=meta),
                                  torch.empty(1, dtype=torch.int32,
                                              device=meta), 32, 0.1)
    xb = torch.empty(4, 256, dtype=torch.bfloat16, device=meta)
    with pytest.raises(ValueError, match="N % 128"):
        kernels.dequant_gemm(xb, torch.empty(32, 96, dtype=torch.int32,
                                             device=meta),
                             torch.empty(2, 96, device=meta), None, None,
                             bits=4, group_size=128, layout="tpu_strided",
                             out_dtype=torch.bfloat16)
    # float32 activations are taken (float32 weights and FMAs); fp16 not
    with pytest.raises(ValueError, match="bf16 or f32 activations"):
        kernels.dequant_gemm(xb.half(), None, torch.empty(2, 128,
                                                          device=meta),
                             None, None, bits=4, group_size=128,
                             layout="tpu_strided", out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int2/int4"):
        kernels.vpu_gemv(xb[0], torch.empty(256, 128, dtype=torch.int8,
                                            device=meta),
                         torch.empty(2, 128, device=meta), None, bits=8,
                         group_size=128, out_dtype=torch.bfloat16)
    # K10's tile must be whole groups dividing K (JAX's _vpu_tiles)
    with pytest.raises(ValueError, match="tk % G"):
        kernels.vpu_int8act(xb[0], torch.empty(32, 128, dtype=torch.int32,
                                               device=meta),
                            torch.empty(2, 128, device=meta), None, bits=4,
                            group_size=128, tk=192,
                            out_dtype=torch.bfloat16)
    # s4_rowpack words pack 8 output columns a word
    with pytest.raises(ValueError, match="N % 8"):
        kernels.s4_gemm(torch.empty(4, 256, dtype=torch.int8, device=meta),
                        torch.empty(256, 12, dtype=torch.int32, device=meta),
                        torch.empty(2, 100, device=meta),
                        torch.empty(4, device=meta))


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
