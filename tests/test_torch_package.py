"""Package boundaries of the PyTorch port: it imports neither JAX nor the
JAX package, and it never lands on the CPU when the card was asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mxnet_tpu_torch
from mxnet_tpu_torch import context
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import gpt
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import mxnet_tpu_torch
for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__, "mxnet_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")
             or n.startswith("google.protobuf"))
print("IMPORTED", len([n for n in sys.modules
                       if n.startswith("mxnet_tpu_torch")]))
print("MODULES", " ".join(sorted(n for n in sys.modules
                                 if n.startswith("mxnet_tpu_torch"))))
print("BAD", bad)
"""

#: modules the training slice added; each must be walked and clean
TRAINING_MODULES = ("mxnet_tpu_torch.parallel",
                    "mxnet_tpu_torch.parallel.trainer",
                    "mxnet_tpu_torch.optimizer",
                    "mxnet_tpu_torch.optimizer.lr_scheduler",
                    "mxnet_tpu_torch.ops.optimizer_op")
#: modules the imperative slice added; each must be walked and clean
IMPERATIVE_MODULES = ("mxnet_tpu_torch.engine", "mxnet_tpu_torch.autograd",
                      "mxnet_tpu_torch.rtc", "mxnet_tpu_torch.ndarray",
                      "mxnet_tpu_torch.ndarray.ndarray",
                      "mxnet_tpu_torch.ndarray.register",
                      "mxnet_tpu_torch.ndarray.utils",
                      "mxnet_tpu_torch.ndarray.random",
                      "mxnet_tpu_torch.ops.registry",
                      "mxnet_tpu_torch.ops.elemwise",
                      "mxnet_tpu_torch.ops.reduce",
                      "mxnet_tpu_torch.ops.matrix",
                      "mxnet_tpu_torch.ops.indexing",
                      "mxnet_tpu_torch.ops.random_ops")

#: modules the BERT slice added; each must be walked and clean
BERT_MODULES = ("mxnet_tpu_torch.initializer",
                "mxnet_tpu_torch.parallel.mesh",
                "mxnet_tpu_torch.tools.bench_bert")

#: modules the ResNet slice added; each must be walked and clean
RESNET_MODULES = ("mxnet_tpu_torch.name", "mxnet_tpu_torch.entry",
                  "mxnet_tpu_torch.ops.nn", "mxnet_tpu_torch.ops.ctc",
                  "mxnet_tpu_torch.gluon.parameter",
                  "mxnet_tpu_torch.gluon.block",
                  "mxnet_tpu_torch.gluon.loss",
                  "mxnet_tpu_torch.gluon.nn",
                  "mxnet_tpu_torch.gluon.nn.activations",
                  "mxnet_tpu_torch.gluon.nn.basic_layers",
                  "mxnet_tpu_torch.gluon.nn.conv_layers",
                  "mxnet_tpu_torch.gluon.model_zoo.vision",
                  "mxnet_tpu_torch.gluon.model_zoo.vision.resnet",
                  "mxnet_tpu_torch.tools.bench_resnet")


#: modules the Gluon-training slice added; each must be walked and clean
TRAINER_MODULES = ("mxnet_tpu_torch.optimizer.optimizer",
                   "mxnet_tpu_torch.optimizer.grouped",
                   "mxnet_tpu_torch.numerics", "mxnet_tpu_torch.amp",
                   "mxnet_tpu_torch.kvstore", "mxnet_tpu_torch.metric",
                   "mxnet_tpu_torch.gluon.utils",
                   "mxnet_tpu_torch.gluon.trainer",
                   "mxnet_tpu_torch.gluon.captured",
                   "mxnet_tpu_torch.tools.bench_trainer")


#: modules the input-path slice added; each must be walked and clean
INPUT_MODULES = ("mxnet_tpu_torch._native", "mxnet_tpu_torch.resilience",
                 "mxnet_tpu_torch.telemetry", "mxnet_tpu_torch.profiler",
                 "mxnet_tpu_torch.recordio", "mxnet_tpu_torch.image",
                 "mxnet_tpu_torch.io", "mxnet_tpu_torch.io.io",
                 "mxnet_tpu_torch.callback",
                 "mxnet_tpu_torch.gluon.data",
                 "mxnet_tpu_torch.gluon.data.sampler",
                 "mxnet_tpu_torch.gluon.data.state",
                 "mxnet_tpu_torch.gluon.data.dataset",
                 "mxnet_tpu_torch.gluon.data._shm_worker",
                 "mxnet_tpu_torch.gluon.data.dataloader",
                 "mxnet_tpu_torch.gluon.data.prefetcher",
                 "mxnet_tpu_torch.gluon.data.vision.datasets",
                 "mxnet_tpu_torch.gluon.data.vision.transforms",
                 "mxnet_tpu_torch.gluon.contrib.data.sampler",
                 "mxnet_tpu_torch.gluon.contrib.data.text",
                 "mxnet_tpu_torch.tools.bench_input_pipeline")


#: modules the decode and serving slice added; each must be walked and clean
DECODE_MODULES = ("mxnet_tpu_torch.obs", "mxnet_tpu_torch.obs.spans",
                  "mxnet_tpu_torch.serving.batcher",
                  "mxnet_tpu_torch.gluon.model_zoo.transformer",
                  "mxnet_tpu_torch.tools.bench_serving",
                  "mxnet_tpu_torch.tools.bench_decode")


#: modules the recurrent slice added; each must be walked and clean
RECURRENT_MODULES = ("mxnet_tpu_torch.operator",
                     "mxnet_tpu_torch.ops.rnn",
                     "mxnet_tpu_torch.ops.control_flow",
                     "mxnet_tpu_torch.ops.linalg",
                     "mxnet_tpu_torch.ops.legacy_output",
                     "mxnet_tpu_torch.ndarray.contrib",
                     "mxnet_tpu_torch.ndarray.linalg",
                     "mxnet_tpu_torch.gluon.rnn",
                     "mxnet_tpu_torch.gluon.rnn.rnn_cell",
                     "mxnet_tpu_torch.gluon.rnn.rnn_layer",
                     "mxnet_tpu_torch.gluon.contrib.rnn",
                     "mxnet_tpu_torch.tools.bench_lstm")


#: modules the detection slice added; each must be walked and clean
DETECTION_MODULES = ("mxnet_tpu_torch.ops.contrib_det",
                     "mxnet_tpu_torch.ops.vision_extra",
                     "mxnet_tpu_torch.image_detection",
                     "mxnet_tpu_torch.gluon.model_zoo.ssd",
                     "mxnet_tpu_torch.gluon.model_zoo.model_store",
                     "mxnet_tpu_torch.gluon.model_zoo.vision.alexnet",
                     "mxnet_tpu_torch.gluon.model_zoo.vision.densenet",
                     "mxnet_tpu_torch.gluon.model_zoo.vision.inception",
                     "mxnet_tpu_torch.gluon.model_zoo.vision.mobilenet",
                     "mxnet_tpu_torch.gluon.model_zoo.vision.squeezenet",
                     "mxnet_tpu_torch.gluon.model_zoo.vision.vgg",
                     "mxnet_tpu_torch.gluon.contrib.nn",
                     "mxnet_tpu_torch.gluon.contrib.cnn",
                     "mxnet_tpu_torch.gluon.contrib.estimator",
                     "mxnet_tpu_torch.tools.bench_ssd")


#: modules the production-planes slice added; each must be walked and
#: clean
PLANES_MODULES = ("mxnet_tpu_torch.checkpoint",
                  "mxnet_tpu_torch.distributed",
                  "mxnet_tpu_torch.integrity",
                  "mxnet_tpu_torch.obs.collector",
                  "mxnet_tpu_torch.obs.exporter",
                  "mxnet_tpu_torch.serving.replica")


#: modules the multi-rank training slice added; each must be walked and
#: clean
MULTIGPU_MODULES = ("mxnet_tpu_torch.gradient_compression",
                    "mxnet_tpu_torch.parallel.collectives",
                    "mxnet_tpu_torch.parallel.sharding",
                    "mxnet_tpu_torch.tools.dist_bert",
                    "mxnet_tpu_torch.tools.dist_paths")


#: modules the deploy and bindings slice added; each must be walked and
#: clean
DEPLOY_MODULES = ("mxnet_tpu_torch.ops.quantization",
                  "mxnet_tpu_torch.contrib",
                  "mxnet_tpu_torch.contrib.quantization",
                  "mxnet_tpu_torch.contrib.onnx",
                  "mxnet_tpu_torch.contrib.onnx.onnx_minimal",
                  "mxnet_tpu_torch.contrib.onnx.mx2onnx",
                  "mxnet_tpu_torch.contrib.onnx.onnx2mx",
                  "mxnet_tpu_torch.test_utils", "mxnet_tpu_torch.runtime",
                  "mxnet_tpu_torch.storage", "mxnet_tpu_torch.c_api_impl")


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert int(res.stdout.split("IMPORTED ")[1].split()[0]) >= 10
    walked = set(res.stdout.split("MODULES ")[1].split("\n")[0].split())
    assert set(TRAINING_MODULES) <= walked, sorted(walked)
    assert set(IMPERATIVE_MODULES) <= walked, sorted(walked)
    assert set(BERT_MODULES) <= walked, sorted(walked)
    assert set(RESNET_MODULES) <= walked, sorted(walked)
    assert set(TRAINER_MODULES) <= walked, sorted(walked)
    assert set(INPUT_MODULES) <= walked, sorted(walked)
    assert set(DECODE_MODULES) <= walked, sorted(walked)
    assert set(RECURRENT_MODULES) <= walked, sorted(walked)
    assert set(DETECTION_MODULES) <= walked, sorted(walked)
    assert set(PLANES_MODULES) <= walked, sorted(walked)
    assert set(MULTIGPU_MODULES) <= walked, sorted(walked)
    assert set(DEPLOY_MODULES) <= walked, sorted(walked)


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_names_jax():
    """Lazy imports inside functions count too: no file of the port, nor
    chip_smoke.py, imports jax or mxnet_tpu anywhere."""
    files = sorted(Path(mxnet_tpu_torch.__file__).parent.rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    # the rank processes of the multi-rank tests run the port alone
    files += [ROOT / "tests" / "torch_rank_worker.py",
              ROOT / "tests" / "torch_rank_cases.py"]
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "mxnet_tpu"}, (f, roots)


def test_gpu_raises_without_a_card():
    if torch.cuda.is_available():
        assert context.gpu(0) == torch.device("cuda", 0)
        with pytest.raises(MXNetError):
            context.gpu(torch.cuda.device_count())
    else:
        with pytest.raises(MXNetError, match="no such CUDA device"):
            context.gpu(0)
    assert context.cpu() == torch.device("cpu")


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        model = gpt.gpt_tiny()
        assert model.tok_embed_weight.data()._data.device.type == "cuda"
    else:
        with pytest.raises(MXNetError, match="no such CUDA device"):
            gpt.gpt_tiny()
        with pytest.raises(MXNetError):
            gpt.gpt_tiny(device="cuda")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """With no CUDA device, or from a directory holding chip_smoke.py and
    nothing else of the repo, the script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run for real")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # both runs at once: each child's time is its interpreter and torch
    runs = [(script, subprocess.Popen(
        [sys.executable, str(script)], cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for script, cwd in ((ROOT / "chip_smoke.py", ROOT),
                            (lone, tmp_path))]
    for script, proc in runs:
        out, _err = proc.communicate(timeout=120)
        assert proc.returncode != 0, (script, out)
        assert '"ok": true' not in out, out


def test_kernel_library_name_follows_its_headers(tmp_path, monkeypatch):
    """A library's file name hashes its source and every csrc/*.cuh, so an
    edited header rebuilds instead of loading a stale library."""
    import shutil

    from mxnet_tpu_torch import _kernels

    pkg = tmp_path / "mxnet_tpu_torch"
    shutil.copytree(Path(mxnet_tpu_torch.__file__).parent, pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(_kernels, "PACKAGE_DIR", pkg)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    headers = sorted((pkg / "csrc").glob("*.cuh"))
    assert headers, "the kernels share a header"
    before = {n: _kernels._lib_path(n) for n in _kernels.SOURCES}
    text = headers[0].read_bytes()
    headers[0].write_bytes(text + b"\n// edited\n")
    after = {n: _kernels._lib_path(n) for n in _kernels.SOURCES}
    assert all(after[n] != before[n] for n in _kernels.SOURCES)
    assert all(p.parent == tmp_path / "build" for p in after.values())
    headers[0].write_bytes(text)
    assert {n: _kernels._lib_path(n) for n in _kernels.SOURCES} == before
    src = pkg / _kernels.SOURCES["flash_attention_fwd"]
    src.write_bytes(src.read_bytes() + b"\n")
    assert _kernels._lib_path("flash_attention_fwd") != \
        before["flash_attention_fwd"]
    assert _kernels._lib_path("flash_attention_bwd") == \
        before["flash_attention_bwd"]


def test_c_api_library_name_follows_its_interpreter(monkeypatch):
    """The C API library's path hashes the interpreter's python3-config
    flags and the compiler, so a library linked against another libpython
    is not loaded from it."""
    from mxnet_tpu_torch import _kernels

    monkeypatch.setattr(_kernels, "_python_flags",
                        lambda: (["-I/a/include/python3.12"],
                                 ["-lpython3.12"]))
    base = _kernels.c_api_path()
    assert _kernels.c_api_path() == base
    monkeypatch.setattr(_kernels, "_python_flags",
                        lambda: (["-I/b/include/python3.12"],
                                 ["-lpython3.12"]))
    assert _kernels.c_api_path() != base
    monkeypatch.setattr(_kernels, "_python_flags",
                        lambda: (["-I/a/include/python3.12"],
                                 ["-lpython3.12"]))
    monkeypatch.setenv("CXX", "clang++")
    assert _kernels.c_api_path() != base


def test_token_partings_allow_only_rounding_ties():
    """Two greedy decodes' tokens may part only where the reference's
    logit gap between the two tokens is within twice the runs' logit
    difference there, and, held by another pair's logits, only while
    that pair's tokens agree before the parting."""
    import numpy as np

    from mxnet_tpu_torch.tools.dist_paths import token_partings

    want = [[1, 2, 3], [4, 5, 6]]
    lg = np.zeros((3, 2, 8), np.float32)
    lg[1, 1, 5], lg[1, 1, 7] = 1.0, 0.999
    near = lg.copy()
    near[1, 1, 7] += 0.001
    (p,) = token_partings(want, [[1, 2, 3], [4, 7, 6]], lg, near)
    assert (p["row"], p["step"], p["tie"]) == (1, 1, True)
    far = lg.copy()
    far[1, 1, 7] = 0.5
    assert not token_partings(want, [[1, 2, 3], [4, 7, 6]], far,
                              far + near - lg)[0]["tie"]
    assert token_partings(want, want, lg, lg) == []
    other = ([[1, 2, 3], [0, 5, 6]], want)
    assert not token_partings(want, [[1, 2, 3], [4, 7, 6]], lg, near,
                              other)[0]["tie"]


def test_fenced_trace_taken_again_after_a_lost_side(monkeypatch):
    """kernel_records takes a trace again when one lost a fence side or a
    mark of the work (both fences kept, the work's records gone between
    them), each new trace padded on the host twice as long, runs the
    traced work once a trace, and raises when every trace lost one."""
    from types import SimpleNamespace

    from mxnet_tpu_torch.tools import trace_edges

    def rec(name, us):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(
            elapsed_us=lambda: us))

    fence = rec(trace_edges.FENCE_NAME, 1000.0)
    mark = rec(trace_edges.FENCE_NAME, 10.0)
    work = rec("flash_fwd_kernel", 50.0)
    traces = [[work, mark, fence], [fence, fence],
              [fence, mark, work, mark, fence]]
    ran, pads = [], []

    def fake_trace(fn, fenced, pad=0.0):
        assert fenced
        pads.append(pad)
        fn()
        return traces.pop(0)

    monkeypatch.setattr(trace_edges, "_trace", fake_trace)
    assert trace_edges.kernel_records(lambda: ran.append(1)) == [work]
    assert len(ran) == 3
    assert pads == [trace_edges.PAD_S * k for k in (1, 2, 4)]
    traces[:] = [[work, fence]] * 3
    pads.clear()
    with pytest.raises(AssertionError, match="3 times"):
        trace_edges.kernel_records(lambda: ran.append(1), attempts=3)
    assert len(ran) == 6
    assert pads == [trace_edges.PAD_S * k for k in (1, 2, 4)]


def test_fenced_trace_lead_counts_from_the_profilers_start(monkeypatch):
    """A fenced trace records the host's time in ``profile.__enter__``
    (``enter_ms``) and counts its lead from the profiler's own start:
    a profiler that starts its clock and then takes a known sleep to
    enter does not show that sleep as lead."""
    import time
    from types import SimpleNamespace

    import torch
    from torch.autograd import DeviceType

    from mxnet_tpu_torch.tools import trace_edges

    enter_s, true_lead_ms = 0.08, 3.0
    box = {}

    class FakeProfile:
        def __init__(self, activities=None):
            pass

        def __enter__(self):
            box["base"] = time.time_ns()
            time.sleep(enter_s)
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            start_us = (box["launch"] - box["base"]) / 1e3 \
                + true_lead_ms * 1e3
            return [SimpleNamespace(name=trace_edges.FENCE_NAME,
                                    device_type=DeviceType.CUDA,
                                    time_range=SimpleNamespace(
                                        start=start_us + k,
                                        elapsed_us=lambda us=us: us))
                    for k, us in enumerate((1000.0, 10.0, 10.0, 1000.0))]

        @property
        def profiler(self):
            return SimpleNamespace(kineto_results=SimpleNamespace(
                trace_start_ns=lambda: box["base"]))

    def fake_fence():
        box.setdefault("launch", time.time_ns())

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(trace_edges, "fence", fake_fence)
    monkeypatch.setattr(trace_edges, "TRACES", [])
    got = trace_edges.reproduce(lambda: None, traces=1)
    assert len(got) == 1 and got[0]["held"] and got[0]["marks"] == 2
    assert got[0]["enter_ms"] >= enter_s * 1e3
    assert 0.0 <= got[0]["base_ms"] < 5.0
    assert abs(got[0]["lead_ms"] - true_lead_ms) < 1.0
