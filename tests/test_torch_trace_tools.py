"""The port's profiling tools (``avsep_tpu_torch/tools/trace_report.py`` and
``insitu_report.py``) and the seven MUSIC launch scripts
(``scripts/*_torch.sh``) against the JAX package's, on the CPU.

The tools read a card's profile and replay a CUDA graph, so here their
plain parts run: the category table on kernel names an H100 run printed
(torch 2.11, CUDA 12.8), the aggregation on hand-made records, the
refusals, the step the trace profiles, the staged batch, arms B and C and
the arithmetic of the report.  No number here is a device's.

Size: tests/test_torch_measure.py's, unet5 at ngf 8 and the tiny conv
encoder on 64x64 frames, 16383 samples, B = 2, random weights in the JAX
shapes carried over by ``from_jax``; the in-situ arms on a class-token set
of 4 classes x 2 videos that ``tools.make_synthetic_data`` writes.

Tolerances: none.  The step through the tool and the direct step are the
same arithmetic in one process (bit for bit); the staged batch equals the
JAX tool's bit for bit (the same host pipeline); the report's arithmetic
is the JAX tool's formulas to the last bit; the scripts' ``Config``s
equal field by field.
"""

import copy
import dataclasses
import math
import os
import re
import runpy
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.config import Config as JConfig
from avsep_tpu.config import parse_args as jparse_args
from avsep_tpu.data.dataset import MusicMixDataset as JMusicMixDataset
from avsep_tpu.data.loader import BatchLoader as JBatchLoader
from avsep_tpu.data.loader import iter_forever as jiter_forever
from avsep_tpu.engine import unused_visual_streams as junused
from avsep_tpu.main import to_device as jto_device
from avsep_tpu.parallel.mesh import make_mesh
from avsep_tpu_torch import engine, train
from avsep_tpu_torch.config import Config, parse_args
from avsep_tpu_torch.data.loader import iter_forever
from avsep_tpu_torch.tools import (
    insitu_report, make_synthetic_data, trace_report)
from tests.test_torch_forward import configs, make_nets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2
CPU = torch.device("cpu")
SMALL = dict(arch_sound="unet5", arch_frame="tinyconv", audLen=16383,
             imgSize=64)


def jax_report_keys(path):
    """The keys of the ``report = {...}`` dict of a JAX tool's source."""
    with open(os.path.join(REPO, path)) as f:
        body = re.search(r"^    report = \{(.*?)^    \}", f.read(),
                         re.S | re.M).group(1)
    # the dict's own lines are indented 8 spaces; nested dicts deeper
    return [k for line in body.splitlines() if re.match(r' {8}"', line)
            for k in re.findall(r'"(\w+)":', line)]


# ------------------------------------------------------- (a) categories

# (kernel, launching op, category): names as torch.profiler gave them for
# the flagship AV step on the H100 (f32 fft and bf16 matmul); the port's
# kernels are launched through ctypes, so no op launched them.  A train
# step runs no iSTFT: overlap_add_kernel's name is its source's signature
# (csrc/overlap_add.cu) in the form the profiler gave frame_window_kernel
NAMED = [
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
     "tilesize256x64x8_stage3_warpsize2x2x1_g1_ffma_aligna4_alignc4_execute_"
     "kernel__5x_cudnn", "aten::cudnn_convolution", "convolution"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize64x64x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__"
     "5x_cudnn", "aten::cudnn_convolution", "convolution"),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_"
     "nhwc_tilesize64x64x64_warpgroupsize1x1x1_g1_execute_segment_k_on_"
     "kernel__5x_cudnn", "aten::convolution_backward", "convolution"),
    ("void wgrad_alg0_engine_NHWC<float, 128, 5, 5, 3, 3, 3, false, 512>(int,"
     " int, int, float const*, int, float*, float const*, kernel_grad_params,"
     " unsigned long long, int, float, int, int, int, int)",
     "aten::convolution_backward", "convolution"),
    # cuDNN's FFT algorithm and its complex GEMM count as the convolution
    ("void fft2d_r2c_64x64<float>(float2*, float const*, int, int, int, int, "
     "int, int, int, int)", "aten::cudnn_convolution", "convolution"),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize32x64x8_stage3_"
     "warpsize2x2x1_ffma_aligna8_alignc8_execute_kernel__5x_cublas",
     "aten::convolution_backward", "convolution"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>("
     "cutlass_80_simt_sgemm_256x128_8x4_nn_align1::Params)", "aten::mm",
     "matmul"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x128x8_stage3_"
     "warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
     "aten::mm", "matmul"),
    ("void regular_fft_factor<7u, EPT<7u>, 64u, 0u, (padding_t)6, "
     "(twiddle_t)0, (loadstore_modifier_t)2, (layout_t)1, unsigned int, "
     "float, HostConfigPlaceholder>(kernel_arguments_t<unsigned int>)",
     "aten::_fft_r2c", "fft"),
    ("void postprocess_kernel<float, unsigned int, (loadstore_modifier_t)2>("
     "real_complex_args_t<unsigned int>)", "aten::_fft_r2c", "fft"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, "
     "false, true, (cudnnKernelDataType_t)0>(cudnn::engines_precompiled::"
     "nchw2nhwc_params_t<float>, float const*, float*)",
     "aten::cudnn_convolution", "copy/transpose"),
    ("Memcpy DtoD (Device -> Device)", "aten::copy_", "copy/transpose"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, float, "
     "4, 4> >(at::native::ReduceOp<float, at::native::MeanOps<float, float, "
     "float, float>, unsigned int, float, 4, 4>)", "aten::mean", "reduce"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::MaxNanFunctor<float> >, "
     "unsigned int, float, 4, 4> >(at::native::ReduceOp<float, at::native::"
     "func_wrapper_t<float, at::native::MaxNanFunctor<float> >, unsigned "
     "int, float, 4, 4>)", "aten::amax", "reduce"),
    ("void cudnn::batchnorm_fwtr_nhwc_semiPersist<float, float, float, 512, "
     "16, 2, 4, 1, 1, false, false, true, 2>(cudnn::NhwcBatchNormFwdParams"
     "<float, float>)", "aten::cudnn_batch_norm", "reduce"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul>)", "aten::add_",
     "fusion/elementwise"),
    ("void at::native::(anonymous namespace)::upsample_bilinear2d_backward_"
     "nhwc_out_frame<float, float>(int, int, int, int, float, float, bool, "
     "float*, float const*, int, unsigned long, unsigned long)",
     "aten::upsample_bilinear2d_backward", "fusion/elementwise"),
    ("void (anonymous namespace)::frame_window_kernel<true>(float const*, "
     "float const*, float*, int, int, int, int, int, int)", None,
     "frame_window"),
    ("void (anonymous namespace)::overlap_add_kernel<2>(float const*, float "
     "const*, float*, int, int, int, int, int, int)", None,
     "overlap_add_normalize"),
    ("Memset (Device)", None, "other"),
]


@pytest.mark.parametrize("kernel,op,category", NAMED,
                         ids=[f"{c}-{i}" for i, (_, _, c) in
                              enumerate(NAMED)])
def test_category_of_h100_kernels(kernel, op, category):
    assert trace_report.categorize(kernel, op) == category


# --------------------------------------------- (b) the aggregation


def records():
    """Two steps' hand-made records: two convolutions, a GEMM, a reduce,
    an elementwise kernel, and frame_window twice per step."""
    R = trace_report.KernelRecord
    conv = NAMED[0][0]
    fw = NAMED[-3][0]
    return [R(conv, "aten::cudnn_convolution", 400.0),
            R(conv, "aten::cudnn_convolution", 380.0),
            R(NAMED[2][0], "aten::convolution_backward", 900.0),
            R(NAMED[6][0], "aten::mm", 50.0),
            R(NAMED[12][0], "aten::mean", 30.0),
            R(NAMED[15][0], "aten::add_", 20.0),
            R(NAMED[15][0], "aten::mul", 10.0)] + [R(fw, None, 12.5)] * 4


def test_aggregate_is_the_jax_arithmetic():
    recs = records()
    wall = 0.004
    r = trace_report.aggregate(recs, 2, wall, top_k=3)
    total = sum(x.us for x in recs)
    assert r["wall_ms_per_step"] == wall / 2 * 1e3
    assert r["device_busy_ms_per_step"] == total / 2 / 1e3
    assert r["device_busy_frac_of_wall"] == (total / 1e6) / wall
    shares = r["category_pct"]
    assert abs(sum(shares.values()) - 100.0) < 1e-9
    assert list(shares.values()) == sorted(shares.values(), reverse=True)
    assert shares["convolution"] == 100.0 * 1680.0 / total
    top = r["top_ops_pct"]
    assert len(top) == 3
    assert [t["pct"] for t in top] == sorted((t["pct"] for t in top),
                                             reverse=True)
    assert top[0] == {"op": NAMED[2][0], "pct": 100.0 * 900.0 / total,
                      "ms_per_step": 900.0 / 2 / 1e3,
                      "contains": ["aten::convolution_backward"]}
    assert top[1]["op"] == NAMED[0][0] and \
        top[1]["ms_per_step"] == 780.0 / 2 / 1e3
    fw = r["port_kernels"]["frame_window"]
    assert fw == {"ms_per_step": 50.0 / 2 / 1e3, "launches": 4}
    assert r["port_kernels"]["overlap_add_normalize"] == \
        {"ms_per_step": 0.0, "launches": 0}
    # a kernel launched by two ops lists both
    full = trace_report.aggregate(recs, 2, wall, top_k=20)["top_ops_pct"]
    add = [t for t in full if t["op"] == NAMED[15][0]][0]
    assert add["contains"] == ["aten::add_", "aten::mul"]
    assert [t for t in full if t["op"] == NAMED[-3][0]][0]["contains"] \
        is None


def test_report_has_every_key_of_the_jax_report():
    cfg = Config(**SMALL)
    r = trace_report.make_report(
        cfg, B, 2, records(), 0.004,
        {"frame_window": 4, "overlap_add_normalize": 0}, "cpu")
    want = jax_report_keys("tools/trace_report.py")
    assert len(want) == 9, want
    assert set(r) == set(want) | {"port_kernels", "card", "calls"}
    assert (r["batch"], r["n_steps"], r["dtype"], r["dft"]) == \
        (B, 2, cfg.dtype, cfg.dft)
    assert r["port_kernels"]["frame_window"]["launches_counted"] == 4
    assert r["calls"] == {"train_step": trace_report.WARMUP + 2}


class _Event:
    def __init__(self, name, device_type, us=0.0, kernels=()):
        from torch.autograd import DeviceType
        from torch.autograd.profiler_util import Interval, Kernel
        self.name = name
        self.device_type = getattr(DeviceType, device_type)
        self.time_range = Interval(0.0, us)
        self.kernels = [Kernel(k, 0, d) for k, d in kernels]


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_kernel_records_attribute_each_kernel_to_its_op():
    """Each kernel goes to the op that enclosed its launch; a CUPTI marker
    that shares the op's correlation (``Command Buffer Full``) and the
    runtime call are not ops; a ctypes launch has no op."""
    conv, fw = NAMED[0][0], NAMED[-3][0]
    prof = _Prof([
        _Event("aten::cudnn_convolution", "CPU", kernels=[(conv, 7.0)]),
        _Event("Command Buffer Full", "CPU", kernels=[(conv, 7.0)]),
        _Event("cudaLaunchKernel", "CPU", kernels=[(conv, 7.0)]),
        _Event("aten::cudnn_convolution", "CPU", kernels=[(conv, 5.0)]),
        _Event(conv, "CUDA", 7.0), _Event(conv, "CUDA", 5.0),
        _Event(fw, "CUDA", 2.0), _Event(fw, "CUDA", 3.0)])
    recs = trace_report.kernel_records(prof)
    R = trace_report.KernelRecord
    assert sorted(recs) == sorted([
        R(conv, "aten::cudnn_convolution", 7.0),
        R(conv, "aten::cudnn_convolution", 5.0),
        R(fw, None, 2.5), R(fw, None, 2.5)])


# ------------------------------------------------------- (c) refusals


@pytest.fixture(scope="module")
def small():
    """The config of bench's flagship cut to the test size, its nets."""
    jcfg, cfg = configs(dft="matmul", binary_mask=1)
    _, _, _, pnets = make_nets(cfg)
    return cfg, pnets


def _state(cfg, nets):
    return train.TrainState(0, nets, train.init_opt_state(cfg, nets))


def test_trace_report_refuses_the_cpu(small):
    cfg, nets = small
    state = _state(cfg, copy.deepcopy(nets))
    with pytest.raises(RuntimeError, match="no device-op events found"):
        trace_report.run(cfg, state, B, 1, device="cpu")
    with pytest.raises(RuntimeError, match="no device-op events found"):
        trace_report.aggregate([], 1, 1.0)


def test_insitu_arm_a_refuses_the_cpu(small):
    cfg, nets = small
    state = _state(cfg, copy.deepcopy(nets))
    step = train.make_train_step(cfg, state.nets, use_vis=True,
                                 device="cpu")
    with pytest.raises(RuntimeError, match="replays a CUDA graph .* needs "
                                           "a card; cpu has none"):
        insitu_report.arm_a(step, state, {}, 2, CPU)


@pytest.mark.parametrize("tool,argv", [
    ("trace_report", ["2", "1"]),
    ("insitu_report", ["--n", "1"])])
def test_command_lines_refuse_to_run_without_a_gpu(tool, argv, toy_set,
                                                   monkeypatch):
    """As python -m runs them: without a card they raise before any
    work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(engine, "full_float32", lambda: None)
    if tool == "insitu_report":
        argv = argv + ["--root", str(toy_set)]
    monkeypatch.setattr(sys, "argv", [tool, *argv])
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        runpy.run_module(f"avsep_tpu_torch.tools.{tool}",
                         run_name="__main__")


def test_insitu_names_the_set_it_needs(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match="make_synthetic_data --root .* --img_size 360"):
        insitu_report.insitu_config(str(tmp_path))


# --------------------------------------------- (d) the production step


def _tensors(state):
    return {**{f"{n}.{k}": v for n, net in state.nets._asdict().items()
               if net is not None for k, v in net.state_dict().items()},
            **{f"m.{g}.{k}": v for g, gs in state.opt_state.items()
               if gs is not None for k, v in gs.momentum.items()}}


def test_the_profiled_step_is_the_production_step(small, monkeypatch):
    """One step through the tool equals one eager production step
    (``train.make_eager_train_step``) on the same draws, bit for bit, and
    the tool builds its step with ``make_eager_train_step``, so that it
    profiles the host's dispatch of every launch."""
    cfg, nets = small
    built = []
    real = train.make_eager_train_step

    def spy(*args, **kw):
        built.append((args[2] if len(args) > 2 else kw["use_vis"]))
        return real(*args, **kw)

    monkeypatch.setattr(trace_report.train, "make_eager_train_step", spy)
    a, b = _state(cfg, copy.deepcopy(nets)), _state(cfg, copy.deepcopy(nets))
    got = trace_report.drawing_step(cfg, a, B, seed=5, device="cpu")()
    assert built == [True]
    batch = trace_report.draw_batch(cfg, B, torch.Generator().manual_seed(5),
                                    CPU)
    assert batch["audios"].shape == (B, 2, cfg.audLen)
    assert batch["frames"].shape == (B, 2, 1, 64, 64, 3)
    _, want = real(cfg, b.nets, use_vis=True, device="cpu")(b, batch)
    assert torch.equal(got["err"], want["err"])
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


class _HostReads(TorchDispatchMode):
    """Records every op that makes a tensor from host data or reads a
    value back to the host."""
    BAD = ("lift_fresh", "_local_scalar_dense", "nonzero", "item")

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(b in str(func) for b in self.BAD):
            self.hits.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("frames", ["float", "uint8"])
def test_av_step_reads_nothing_from_the_host_after_its_first(small,
                                                             frames):
    """What arm A's CUDA graph needs: after one call, the AV train step
    makes no tensor from host data and reads nothing back to the host (a
    copy from the host or a sync inside a capture stops it)."""
    cfg, nets = small
    state = _state(cfg, copy.deepcopy(nets))
    step = train.make_train_step(cfg, state.nets, use_vis=True,
                                 device="cpu")
    g = torch.Generator().manual_seed(3)
    shape = (B, 2, 1, 64, 64, 3)
    batch = {"audios": 0.1 * torch.randn(B, 2, cfg.audLen, generator=g),
             "frames": torch.rand(shape, generator=g) if frames == "float"
             else torch.randint(0, 256, shape, generator=g,
                                dtype=torch.uint8)}
    step(state, batch)
    with _HostReads() as mode:
        step(state, batch)
    assert mode.hits == []


# ------------------------------------------ (e) the staged batch


@pytest.fixture(scope="module")
def toy_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("insitu_set")
    make_synthetic_data.main([
        "--root", str(root), "--classes", "cello", "flute", "violin",
        "trumpet", "--videos_per_class", "2", "--duration", "4", "--fps",
        "8", "--class_tokens", "--img_size", "72", "96"])
    return root


def _insitu_cfg(root):
    return insitu_report.insitu_config(str(root), B, "float32", "matmul",
                                       0).replace(vis_channels=32, **SMALL)


def test_staged_batch_equals_the_jax_tools(toy_set):
    """``to_device(next(iter_forever(loader)))`` of both tools on one set
    (tools/insitu_report.py:104-112): the same keys, bit for bit."""
    cfg = _insitu_cfg(toy_set)
    fields = {f.name for f in dataclasses.fields(JConfig)}
    jcfg = JConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                      if k in fields})
    jds = JMusicMixDataset(jcfg.av_list_train[0], jcfg, split="train")
    jloader = JBatchLoader(jds, jcfg.batch_size, shuffle=True,
                           num_workers=jcfg.workers, seed=jcfg.seed)
    want = jto_device(next(jiter_forever(jloader)), make_mesh(1),
                      drop=junused(jcfg), cfg=jcfg)
    ds, loader = insitu_report.build_loader(cfg)
    got = insitu_report.putter(cfg, CPU)(next(iter_forever(loader)))
    loader.close()
    assert set(got) == set(want) and "frames" in got
    for k in got:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


# ---------------------------------------- (f) arms B and C on the CPU


def test_arms_b_and_c_give_the_jax_report(toy_set):
    cfg = _insitu_cfg(toy_set)
    _, _, _, nets = make_nets(cfg)
    state = _state(cfg, nets)
    r = insitu_report.run(cfg, state, 2, device="cpu", root=str(toy_set))
    want = jax_report_keys("tools/insitu_report.py")
    assert len(want) == 18 and tuple(want) == insitu_report.JAX_KEYS
    assert set(r) == set(want) | set(insitu_report.ADDED_KEYS)
    assert r["device"] == "cpu" and r["card"] == "cpu"
    assert r["frame_route"] in ("native", "fast", "pil")
    assert r["calls"] == {"train_step": 1 + 2 * 2}
    for k in ("arm_b_dispatch_ms_per_step", "arm_c_insitu_ms_per_step",
              "mean_data_wait_ms", "unhidden_host_data_ms",
              "clips_per_s_insitu"):
        assert math.isfinite(r[k]), k
    # arm A and the profile need a card: not measured here
    for k in ("arm_a_scan_ms_per_step", "dispatch_rpc_ms",
              "clips_per_s_scan_floor", "device_busy_ms_per_step",
              "device_busy_frac_of_insitu_wall", "arm_a_method",
              "arm_a_check", "arm_c_port_kernels"):
        assert r[k] is None, k
    assert r["unhidden_host_data_ms"] == \
        r["arm_c_insitu_ms_per_step"] - r["arm_b_dispatch_ms_per_step"]


@pytest.mark.parametrize("a,b,c,busy", [
    (35.18, 55.56, 158.58, 35.74), (133.4, 138.8, 160.4, 134.1),
    (None, 61.8, 131.0, None), (35.3, 61.8, 131.0, None)])
def test_insitu_arithmetic_is_the_jax_formulas(a, b, c, busy):
    """tools/insitu_report.py:205-221, on given numbers (None where the
    port did not measure)."""
    got = insitu_report.derived(32, a, b, c, busy)
    assert got == {
        "dispatch_rpc_ms": None if a is None else b - a,
        "unhidden_host_data_ms": c - b,
        "device_busy_frac_of_insitu_wall": busy / c if busy else None,
        "clips_per_s_insitu": 32 / (c / 1e3),
        "clips_per_s_scan_floor": None if a is None else 32 / (a / 1e3)}


# ---------------------------------------------- (g) the launch scripts

# each port script, the JAX script it stands for, and the module both run
SCRIPTS = [("train_MUSIC", "main"), ("train_MUSIC+", "main"),
           ("eval_MUSIC", "main"), ("train_SoPpp", "sop_main"),
           ("inference", "inference"), ("vis_model", "inference"),
           ("vis_sound_map", "inference")]


def script_flags(name):
    """The flags of ``scripts/<name>``: its ``args=( ... )`` array
    (comments dropped) or its ``OPTS+="..."`` lines, ``${MODE}`` at its
    default ``vis``."""
    with open(os.path.join(REPO, "scripts", name)) as f:
        text = f.read()
    array = re.search(r"^args=\((.*?)^\)", text, re.S | re.M)
    if array:
        return shlex.split("\n".join(line.split("#")[0]
                                     for line in array.group(1).splitlines()))
    parts = re.findall(r'^OPTS\+="([^"]*)"', text, re.M)
    assert parts, name
    return shlex.split(" ".join(parts).replace("${MODE}", "vis"))


def python_line(name):
    with open(os.path.join(REPO, "scripts", name)) as f:
        lines = [line for line in f if line.startswith("python ")]
    assert len(lines) == 1, name
    return lines[0].split()


@pytest.mark.parametrize("name,module", SCRIPTS,
                         ids=[n for n, _ in SCRIPTS])
def test_torch_script_parses_as_the_jax_script(name, module):
    """The port script's flags under the port's parser give the JAX
    script's ``Config`` under JAX's, field by field; its one python line
    runs ``avsep_tpu_torch.<the JAX script's module>``; ``bash -n``
    passes."""
    port_flags = script_flags(f"{name}_torch.sh")
    jax_flags = script_flags(f"{name}.sh")
    assert port_flags == jax_flags
    got, want = parse_args(port_flags), jparse_args(jax_flags)
    # arch_motion is the port's own field (the JAX package builds the
    # fast pathway alone): it holds its default
    assert got.arch_motion == "slowfast_fast"
    shared = [f.name for f in dataclasses.fields(Config)
              if f.name != "arch_motion"]
    assert len(shared) > 60
    for field in shared:
        assert getattr(got, field) == getattr(want, field), field
    jline, pline = python_line(f"{name}.sh"), python_line(f"{name}_torch.sh")
    assert jline[jline.index("-m") + 1] == f"avsep_tpu.{module}"
    assert pline[pline.index("-m") + 1] == f"avsep_tpu_torch.{module}"
    assert pline[:pline.index("-m")] == jline[:jline.index("-m")]
    assert pline[pline.index("-m") + 2:] == jline[jline.index("-m") + 2:]
    r = subprocess.run(["bash", "-n",
                        os.path.join(REPO, "scripts", f"{name}_torch.sh")],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    with open(os.path.join(REPO, "scripts", f"{name}_torch.sh")) as f:
        text = f.read()
    assert "avsep_tpu." not in text.replace("avsep_tpu_torch.", "")
    assert "fetch_resnet18.py --out" not in text
