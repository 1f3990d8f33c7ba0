"""The deployment path of the PyTorch port — `jit.save` / `jit.load`
(paddle_tpu_torch/jit/api.py), the predictor (`inference.Config`,
`create_predictor`, `Predictor`, `PrecisionType`;
`inference.serving.standalone_load`, `PredictorPool`) and checkpoint
I/O (`framework.io`) — against the JAX package's (paddle_tpu/jit/api.py,
paddle_tpu/inference/__init__.py and serving.py, framework/io.py), on
the CPU.

The same weights cross by name and value (`load_reference_arrays`) and
the same inputs, made with numpy from a seed, go through the JAX
package's `jit.save` -> `create_predictor` and the port's.  The JAX
`jax.export` of ERNIE fails on a symbolic batch, so the cross-package
artifacts use fixed shapes; the port's dynamic batch is held to its own
eager model.  Tolerances: logits within 1e-5 x max(1, max |JAX|) (fp32
sums in another order through two post-LN layers); the port's program
against the port's eager model on the CPU bitwise (the same kernels in
the same order); a Linear stack against the JAX one within 1e-5."""

import os
import pickle
import shutil
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch import jit
from paddle_tpu_torch.framework import io as TIO
from paddle_tpu_torch.inference import (Config, PrecisionType, Predictor,
                                        create_predictor)
from paddle_tpu_torch.inference.serving import (PredictorPool,
                                                StandalonePredictor,
                                                standalone_load)
from paddle_tpu_torch.models import (ErnieConfig,
                                     ErnieForSequenceClassification,
                                     LlamaConfig, LlamaForCausalLM,
                                     load_reference_arrays)
from paddle_tpu_torch.nn.layer import Linear
from paddle_tpu_torch.ops import flash_attention as FA

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
S = 16


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=1e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _cpu(path):
    config = Config(path)
    config.disable_gpu()
    return create_predictor(config)


class _Positional(torch.nn.Module):
    """ERNIE as forward(ids, mask), or forward(ids) without a mask."""

    def __init__(self, model, masked=True):
        super().__init__()
        self.m = model
        self.masked = masked

    def forward(self, ids, mask=None):
        return self.m(ids, attention_mask=mask if self.masked else None)


def _batch(b, seed, pad=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, S))
    mask = np.ones((b, S), np.int64)
    if pad:
        mask[-1, S - 5:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def ernie(tmp_path_factory):
    """The tiny ERNIE of both packages with the JAX weights, each saved
    as forward(ids, mask) and forward(ids): the JAX artifacts at a fixed
    [2, 16], the port's masked one with a None batch."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.jit.api import InputSpec as JSpec
    from paddle_tpu.models import ernie as J

    class JPositional(jnn.Layer):
        def __init__(self, model, masked=True):
            super().__init__()
            self.m = model
            self.masked = masked

        def forward(self, ids, mask=None):
            return self.m(ids, attention_mask=mask if self.masked else None)

    paddle.seed(0)
    jm = J.ErnieForSequenceClassification(
        J.ErnieConfig.from_preset("tiny", **NO_DROPOUT), num_classes=2)
    jm.eval()
    tm = ErnieForSequenceClassification(
        ErnieConfig.from_preset("tiny", **NO_DROPOUT), num_classes=2,
        device="cpu").eval()
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    load_reference_arrays(tm, arrays)
    d = tmp_path_factory.mktemp("ernie")
    paths = {}
    for masked in (True, False):
        key = "masked" if masked else "unmasked"
        n_in = 2 if masked else 1
        paths["jax", key] = str(d / f"jax_{key}")
        paddle.jit.save(JPositional(jm, masked), paths["jax", key],
                        input_spec=[JSpec([2, S], "int64")] * n_in)
        paths["port", key] = str(d / f"port_{key}")
        jit.save(_Positional(tm, masked), paths["port", key],
                 input_spec=[jit.InputSpec([None if masked else 2, S],
                                           "int64")] * n_in)
    return {"jax": jm, "port": tm, "arrays": arrays, "paths": paths}


@pytest.mark.parametrize("case", ["padded", "all_ones", "no_mask"])
def test_port_predictor_matches_jax_predictor_on_tiny_ernie(ernie, case):
    """The JAX package's jit.save -> create_predictor and the port's
    (disable_gpu) on the same weights and batch: the same input / output
    names and the logits within 1e-5; the port's program equals its
    eager model bitwise."""
    from paddle_tpu.inference import create_predictor as jax_predictor
    from paddle_tpu.inference import Config as JConfig
    key = "unmasked" if case == "no_mask" else "masked"
    ids, mask = _batch(2, 3, pad=case == "padded")
    inputs = [ids] if case == "no_mask" else [ids, mask]
    jp = jax_predictor(JConfig(ernie["paths"]["jax", key]))
    tp = _cpu(ernie["paths"]["port", key])
    want = jp.run(inputs)[0]
    got = tp.run(inputs)[0]
    assert tp.get_input_names() == jp.get_input_names() \
        == [f"x{i}" for i in range(len(inputs))]
    assert tp.get_output_names() == jp.get_output_names() == ["out0"]
    assert got.shape == want.shape == (2, 2) and got.dtype == np.float32
    _close(got, want)
    with torch.no_grad():
        eager = _Positional(ernie["port"], case != "no_mask")(
            *(torch.from_numpy(x) for x in inputs)).numpy()
    assert np.array_equal(got, eager)


def test_exported_ernie_holds_k1_as_one_node_a_layer(ernie):
    """K1 is one `paddle_tpu_torch::flash_fwd` node a layer of the saved
    program (no autograd node, no plain attention), saving launches
    nothing, and the program's inputs are the spec's."""
    program = torch.export.load(ernie["paths"]["port", "masked"] + ".pt2")
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert sum("paddle_tpu_torch.flash_fwd" in t for t in targets) == 2
    assert not any("einsum" in t or "softmax" in t for t in targets)
    pred = standalone_load(ernie["paths"]["port", "masked"], device="cpu")
    assert len(pred.input_avals) == 2
    assert all(a.startswith("int64[") and a.endswith(",16]")
               for a in pred.input_avals)


@pytest.mark.parametrize("b", [1, 3])
def test_port_ernie_takes_a_dynamic_batch(ernie, b):
    """The port's ERNIE saved with InputSpec([None, 16]) runs batches the
    trace never saw (traced at 2), bitwise its eager model."""
    ids, mask = _batch(b, 10 + b)
    got = _cpu(ernie["paths"]["port", "masked"]).run([ids, mask])[0]
    with torch.no_grad():
        want = ernie["port"](torch.from_numpy(ids),
                             attention_mask=torch.from_numpy(mask)).numpy()
    assert got.shape == (b, 2) and np.array_equal(got, want)


def test_jax_pdparams_load_into_the_port(ernie):
    """A `.pdparams` the JAX package wrote (jit.save's state dict) read
    by the port's `framework.io.load`: the same arrays by name, torch
    tensors without `return_numpy`; through `load_reference_arrays` into
    a fresh port model, the same logits."""
    path = ernie["paths"]["jax", "masked"] + ".pdparams"
    arrays = TIO.load(path, return_numpy=True)
    want = {f"m.{n}": a for n, a in ernie["arrays"].items()}
    assert sorted(arrays) == sorted(want)
    for n, a in want.items():
        assert isinstance(arrays[n], np.ndarray)
        assert arrays[n].dtype == a.dtype and np.array_equal(arrays[n], a)
    tensors = TIO.load(path)
    assert all(isinstance(t, torch.Tensor) for t in tensors.values())
    fresh = ErnieForSequenceClassification(
        ErnieConfig.from_preset("tiny", **NO_DROPOUT), num_classes=2,
        device="cpu", seed=7).eval()
    load_reference_arrays(fresh, {n[2:]: a for n, a in arrays.items()})
    ids, mask = (torch.from_numpy(x) for x in _batch(2, 4))
    with torch.no_grad():
        assert torch.equal(fresh(ids, attention_mask=mask),
                           ernie["port"](ids, attention_mask=mask))


def test_jax_bf16_pdparams_load_into_the_port(tmp_path):
    """A JAX `paddle.save` of bfloat16 tensors (the Llama weights' dtype;
    the pickle names `ml_dtypes.bfloat16`) read by the port's `load`:
    torch bfloat16 tensors bit for bit, and with `return_numpy` fp32
    arrays of the same values, which `load_reference_arrays` puts into
    a bfloat16 Linear bit for bit; fp32 beside them unchanged; any other
    ml_dtypes global refused."""
    pytest.importorskip("jax")
    import ml_dtypes
    import paddle_tpu as paddle
    rng = np.random.default_rng(8)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    path = str(tmp_path / "bf16.pdparams")
    paddle.save({"weight": paddle.to_tensor(w).astype("bfloat16"),
                 "bias": paddle.to_tensor(b).astype("bfloat16"),
                 "extra": [paddle.to_tensor(w)]}, path)
    bits = {n: a.astype(ml_dtypes.bfloat16).view(np.int16)
            for n, a in (("weight", w), ("bias", b))}
    tensors = TIO.load(path)
    for n in ("weight", "bias"):
        assert tensors[n].dtype == torch.bfloat16
        assert torch.equal(tensors[n].view(torch.int16),
                           torch.from_numpy(bits[n]))
    assert torch.equal(tensors["extra"][0], torch.from_numpy(w))
    arrays = TIO.load(path, return_numpy=True)
    for n in ("weight", "bias"):
        assert arrays[n].dtype == np.float32
        assert np.array_equal(arrays[n], bits[n].view(ml_dtypes.bfloat16)
                              .astype(np.float32))
    lin = Linear(4, 3).to(torch.bfloat16)
    load_reference_arrays(lin, {n: arrays[n] for n in ("weight", "bias")})
    assert torch.equal(lin.weight, tensors["weight"])
    assert torch.equal(lin.bias, tensors["bias"])
    fp8 = tmp_path / "fp8.pdparams"
    fp8.write_bytes(pickle.dumps(w.astype(ml_dtypes.float8_e4m3fn)))
    with pytest.raises(pickle.UnpicklingError,
                       match="ml_dtypes.float8_e4m3fn"):
        TIO.load(str(fp8))


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


def test_load_refuses_any_other_global(tmp_path):
    """A pickle naming a global other than the payload class, plain
    builtin types and numpy's array rebuild is refused before it runs;
    the port's own files round-trip (nested, bf16 kept)."""
    bad = tmp_path / "evil.pdparams"
    bad.write_bytes(pickle.dumps({"w": _Evil()}))
    with pytest.raises(pickle.UnpicklingError, match="posix.system"):
        TIO.load(str(bad))
    getattr_pickle = tmp_path / "getattr.pdparams"
    getattr_pickle.write_bytes(pickle.dumps(getattr))
    with pytest.raises(pickle.UnpicklingError, match="builtins.getattr"):
        TIO.load(str(getattr_pickle))
    obj = {"a": torch.arange(6.0).reshape(2, 3),
           "b": [torch.ones(2, dtype=torch.bfloat16), 3, "x"],
           "c": (torch.tensor([1, 2]), {"d": 1.5})}
    TIO.save(obj, str(tmp_path / "m.pdparams"))
    assert not (tmp_path / "m.pdparams.tmp").exists()
    back = TIO.load(str(tmp_path / "m.pdparams"))
    assert torch.equal(back["a"], obj["a"])
    assert back["b"][0].dtype == torch.bfloat16 \
        and torch.equal(back["b"][0], obj["b"][0]) and back["b"][1:] == [3, "x"]
    assert isinstance(back["c"], tuple) and back["c"][1] == {"d": 1.5}
    assert torch.equal(back["c"][0], obj["c"][0])
    assert isinstance(TIO.load(str(tmp_path / "m.pdparams"),
                               return_numpy=True)["a"], np.ndarray)


def _mlp(jnn=None):
    """Linear(4, 8) - ReLU - Linear(8, 2): the JAX package's, or the
    port's (`jnn` None)."""
    if jnn is not None:
        return jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    g = torch.Generator().manual_seed(0)
    return torch.nn.Sequential(Linear(4, 8, generator=g), torch.nn.ReLU(),
                               Linear(8, 2, generator=g))


def test_handle_api_on_a_linear_relu_linear(tmp_path):
    """`test_sparse_quant_geo.py:98` on the port: jit.save with an
    InputSpec([2, 4]) -> create_predictor: input names ["x0"], run([x]),
    then the zero-copy handles (`copy_from_cpu(2 * x)`, `run()`,
    `reshape`, `shape`, output handle "out0"), against the JAX
    predictor on the same weights within 1e-5 and the port's eager net
    bitwise."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.inference import Config as JConfig
    from paddle_tpu.inference import create_predictor as jax_predictor
    from paddle_tpu.jit.api import InputSpec as JSpec
    paddle.seed(1)
    jnet, net = _mlp(jnn), _mlp()
    weights = {n: np.asarray(p._data) for n, p in jnet.named_parameters()}
    load_reference_arrays(net, weights)
    jpath, path = str(tmp_path / "jm"), str(tmp_path / "m")
    paddle.jit.save(jnet, jpath, input_spec=[JSpec([2, 4], "float32")])
    jit.save(net, path, input_spec=[jit.InputSpec([2, 4], "float32")])
    pred = _cpu(path)
    assert isinstance(pred, Predictor)
    assert pred.get_input_names() == ["x0"]
    x = np.random.default_rng(0).normal(size=(2, 4)).astype(np.float32)
    jpred = jax_predictor(JConfig(jpath))
    outs = pred.run([x])
    with torch.no_grad():
        assert np.array_equal(outs[0], net(torch.from_numpy(x)).numpy())
    _close(outs[0], jpred.run([x])[0])
    h = pred.get_input_handle("x0")
    h.copy_from_cpu(2 * x)
    assert h.shape() == [2, 4]
    outs2 = pred.run()
    with torch.no_grad():
        assert np.array_equal(outs2[0],
                              net(torch.from_numpy(2 * x)).numpy())
    _close(outs2[0], jpred.run([2 * x])[0])
    out = pred.get_output_handle("out0")
    assert pred.get_output_names() == ["out0"] and out.shape() == [2, 2]
    assert np.array_equal(out.copy_to_cpu(), outs2[0])
    out.reshape([4])
    assert out.shape() == [4]
    with pytest.raises(KeyError):
        pred.get_input_handle("x1")


def test_input_spec_none_batch_through_predictor_and_jit_load(tmp_path):
    """`test_namespace_tail.py:590` on the port: a Linear saved with
    InputSpec([None, 4]) by both packages on the same weights runs
    batches 1, 3 and 7 through the port's predictor and `jit.load`'s
    TranslatedLayer (tensors in and out) within 1e-5 of the JAX
    predictor, and bitwise the port's eager forward."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.inference import Config as JConfig
    from paddle_tpu.inference import create_predictor as jax_predictor
    from paddle_tpu.jit.api import InputSpec as JSpec
    paddle.seed(2)
    jlin = jnn.Linear(4, 2)
    jlin.eval()
    lin = Linear(4, 2).eval()
    load_reference_arrays(lin, {n: np.asarray(p._data)
                                for n, p in jlin.named_parameters()})
    jpath, path = str(tmp_path / "jlin"), str(tmp_path / "lin")
    paddle.jit.save(jlin, jpath, input_spec=[JSpec([None, 4], "float32")])
    jit.save(lin, path, input_spec=[jit.InputSpec([None, 4], "float32")])
    jpred = jax_predictor(JConfig(jpath))
    pred = _cpu(path)
    loaded = jit.load(path, device="cpu")
    assert type(loaded).__name__ == "TranslatedLayer"
    rng = np.random.default_rng(3)
    for b in (1, 3, 7):
        x = rng.random((b, 4)).astype(np.float32)
        want = jpred.run([x])[0]
        got = pred.run([x])[0]
        assert got.shape == want.shape == (b, 2)
        _close(got, want)
        out = loaded(torch.from_numpy(x))
        _close(out.numpy(), want)
        with torch.no_grad():
            eager = lin(torch.from_numpy(x))
        assert np.array_equal(got, eager.numpy()) and torch.equal(out, eager)


class _FcTanh(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = Linear(8, 3, generator=torch.Generator().manual_seed(4))

    def forward(self, x):
        return torch.tanh(self.fc(x))


def test_standalone_loader_and_pool(tmp_path):
    """`test_auto_serving.py:67` on the port, with a None batch: the same
    Linear-tanh saved by both packages on the same weights;
    `standalone_load` (the path with or without `.pt2`, no model class
    built) and a PredictorPool of 3 serving six threads at batches 1, 3
    and 7 give the JAX `standalone_load`'s output within 1e-5, and the
    port's eager forward bitwise; `retrieve()` goes round robin,
    `retrieve(i)` picks one."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.inference.serving import standalone_load as jax_load
    from paddle_tpu.jit.api import InputSpec as JSpec

    class JFcTanh(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = jnn.Linear(8, 3)

        def forward(self, x):
            return paddle.tanh(self.fc(x))

    paddle.seed(4)
    jm, m = JFcTanh(), _FcTanh()
    load_reference_arrays(m, {n: np.asarray(p._data)
                              for n, p in jm.named_parameters()})
    jpath, path = str(tmp_path / "jserved"), str(tmp_path / "served")
    paddle.jit.save(jm, jpath, input_spec=[JSpec([None, 8], "float32")])
    jit.save(m, path, input_spec=[jit.InputSpec([None, 8], "float32")])
    jpred = jax_load(jpath)
    pred = standalone_load(path, device="cpu")
    assert isinstance(pred, StandalonePredictor)
    assert pred.device == torch.device("cpu")
    (aval,) = pred.input_avals
    assert aval.startswith("float32[") and aval.endswith(",8]") \
        and aval != "float32[2,8]"
    rng = np.random.RandomState(0)
    xs = {b: rng.rand(b, 8).astype(np.float32) for b in (1, 3, 7)}
    want = {b: jpred.run(x) for b, x in xs.items()}
    for b, x in xs.items():
        got = pred.run(x)
        assert got.shape == want[b].shape == (b, 3)
        _close(got, want[b])
        with torch.no_grad():
            assert np.array_equal(got, m(torch.from_numpy(x)).numpy())
        assert np.array_equal(
            standalone_load(path + ".pt2", device="cpu")(x), got)
    pool = PredictorPool(path, size=3, device="cpu")
    assert len(pool) == 3
    assert [pool.retrieve() for _ in range(4)] == [
        pool.retrieve(0), pool.retrieve(1), pool.retrieve(2),
        pool.retrieve(0)]
    results = {}

    def worker(i):
        results[i] = pool.retrieve().run(xs[(1, 3, 7)[i % 3]])

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(results) == 6
    for i, r in results.items():
        b = (1, 3, 7)[i % 3]
        _close(r, want[b])
        assert np.array_equal(r, pred.run(xs[b]))
    config = Config(path)
    config.disable_gpu()
    assert isinstance(PredictorPool(config, size=2).retrieve(1), Predictor)
    with pytest.raises(FileNotFoundError, match="jit.save"):
        standalone_load(str(tmp_path / "nothing"), device="cpu")


def test_a_program_loaded_by_path_runs_on_the_card(tmp_path):
    """`standalone_load(path)`, `PredictorPool(path, n)` and `jit.load`
    without a device run on the card, whatever device the program was
    saved on: here, where there is none, each raises (as
    `default_device()` does) instead of running on the CPU; with
    `device="cpu"` each runs here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    path = str(tmp_path / "m")
    jit.save(_FcTanh(), path, input_spec=[jit.InputSpec([2, 8], "float32")])
    for load in (lambda: standalone_load(path),
                 lambda: standalone_load(path + ".pt2"),
                 lambda: PredictorPool(path, size=2),
                 lambda: jit.load(path)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load()
    x = np.zeros((2, 8), np.float32)
    assert standalone_load(path, device="cpu").run(x).shape == (2, 3)
    assert PredictorPool(path, 2, device="cpu").retrieve().run(x).shape \
        == (2, 3)
    assert jit.load(path, device="cpu")(torch.from_numpy(x)).shape == (2, 3)


def test_jit_load_params_only_artifact_and_jax_pdexport(tmp_path):
    """`jit.load` of a params-only save gives the state dict; of a saved
    program a TranslatedLayer whose `train()` raises; of a path whose
    artifact is the JAX package's `.pdexport` (alone, or beside its
    `.pdparams`) a ValueError naming it."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.jit.api import InputSpec as JSpec
    m = _FcTanh()
    jit.save(m, str(tmp_path / "params"))
    assert sorted(os.listdir(tmp_path)) == ["params.pdparams"]
    state = jit.load(str(tmp_path / "params"))
    assert sorted(state) == ["fc.bias", "fc.weight"]
    assert all(torch.equal(state[n], t) for n, t in m.state_dict().items())
    jit.save(m, str(tmp_path / "prog"),
             input_spec=[jit.InputSpec([2, 8], "float32")])
    loaded = jit.load(str(tmp_path / "prog"), device="cpu")
    assert loaded.eval() is loaded
    with pytest.raises(RuntimeError, match="inference artifact"):
        loaded.train()
    jpath = str(tmp_path / "jax")
    paddle.jit.save(jnn.Linear(8, 3), jpath,
                    input_spec=[JSpec([2, 8], "float32")])
    with pytest.raises(ValueError, match=r"jax\.pdexport"):
        jit.load(jpath)
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(jpath + ".pdexport", alone / "jax.pdexport")
    with pytest.raises(ValueError, match="StableHLO"):
        jit.load(str(alone / "jax"))


def test_precision_type_equals_the_jax_constants():
    pytest.importorskip("jax")
    from paddle_tpu.inference import PrecisionType as JPrecision
    names = ("Float32", "Half", "Bfloat16", "Int8")
    assert [getattr(PrecisionType, n) for n in names] == \
        [getattr(JPrecision, n) for n in names] == [0, 1, 2, 3]


def test_config_runs_on_the_card_unless_told_otherwise(tmp_path):
    """Without `disable_gpu()` the predictor runs on the card, and here,
    where there is none, `create_predictor` raises (as
    `default_device()` does), also for `enable_use_gpu(device_id=0)`;
    TensorRT is refused; the other knobs are inert."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    path = str(tmp_path / "m")
    jit.save(_FcTanh(), path, input_spec=[jit.InputSpec([2, 8], "float32")])
    config = Config(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_predictor(config)
    config.enable_use_gpu(100, device_id=0)
    assert config._device == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="not available"):
        create_predictor(config)
    with pytest.raises(NotImplementedError, match="TensorRT"):
        config.enable_tensorrt_engine()
    config.enable_memory_optim(False)
    config.switch_ir_optim(True)
    config.disable_gpu()
    config.set_model(path + ".pt2")
    assert create_predictor(config).run(
        [np.zeros((2, 8), np.float32)])[0].shape == (2, 3)


def test_training_mode_save_with_dropout_raises(tmp_path):
    """A layer in training mode with dropout is refused before anything
    is written (the port keeps no fixed key: the program would replay
    one mask); in eval mode, or in training mode without dropout, it
    saves."""
    cfg = ErnieConfig.from_preset("tiny")
    model = ErnieForSequenceClassification(cfg, device="cpu").train()
    spec = [jit.InputSpec([2, S], "int64")] * 2
    with pytest.raises(ValueError, match="training mode with dropout"):
        jit.save(_Positional(model), str(tmp_path / "train"),
                 input_spec=spec)
    assert os.listdir(tmp_path) == []
    lin = _FcTanh().train()
    jit.save(lin, str(tmp_path / "lin"),
             input_spec=[jit.InputSpec([2, 8], "float32")])
    assert sorted(os.listdir(tmp_path)) == [
        "lin.pdmeta", "lin.pdparams", "lin.pt2"]
    with open(tmp_path / "lin.pdmeta", "rb") as f:
        assert pickle.load(f) == {"input_spec": [([2, 8], "float32")]}


def test_tiny_llama_program_runs_like_its_eager_forward(tmp_path):
    """The tiny Llama (mask-free causal route, GQA 4 / 2) saved with a
    None batch: K1 one node a layer, the predictor's logits at batches 1
    and 3 bitwise the eager forward's, and no launch counted on the
    CPU."""
    model = LlamaForCausalLM(LlamaConfig.from_preset("tiny"),
                             device="cpu").eval()
    path = str(tmp_path / "llama")
    jit.save(model, path, input_spec=[jit.InputSpec([None, 12], "int64")])
    program = torch.export.load(path + ".pt2")
    assert sum("paddle_tpu_torch.flash_fwd" in str(n.target)
               for n in program.graph.nodes) == 2
    pred = _cpu(path)
    before = dict(FA.LAUNCHES)
    rng = np.random.default_rng(6)
    for b in (1, 3):
        ids = rng.integers(0, 256, (b, 12))
        with torch.no_grad():
            want = model(torch.from_numpy(ids)).numpy()
        got = pred.run([ids])[0]
        assert got.shape == (b, 12, 256) and np.array_equal(got, want)
    assert FA.LAUNCHES == before
