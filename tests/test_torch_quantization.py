"""Quantization in the PyTorch port (paddle_tpu_torch/quantization/:
`fake_quantize_abs_max`, `QuantConfig`, `QAT`, `PTQ`,
`quantize_for_inference`, `Int8Linear`, `Int8Conv2D`; kernel Q2 in
ops/int8_linear.py) against the JAX package's
(paddle_tpu/quantization/), on the CPU, where Q2 runs its plain version.
Weights cross by name and value; inputs are made with numpy from a seed.

Tolerances, each with its reason:
* fake-quant values bitwise the JAX function evaluated op by op (the
  same fp32 operations, elementwise), its gradient exactly the
  identity.  The JAX package runs the op jitted, where XLA turns
  `/ qmax` into `* fp32(1 / qmax)` and contracts it with `- x` into one
  FMA: values `QAT.convert` bakes there are within one fp32 ulp of the
  written expression, which the port computes;
* QAT forward logits within 1e-5 x max(1, max |JAX|) and every gradient
  within 1e-4 of its max |JAX| (the fp32 limits of test_torch_ernie.py;
  the activation quanters' per-tensor scale is a max, exact in both),
  `convert`'s baked weights bitwise;
* calibrated absmax per layer within 1e-6 relative (fp32 activations
  whose sums run in another order); wq and w_scale bitwise (the same
  fp32 arithmetic, round half to even);
* int8 logits with JAX's absmax fed to both packages within 2e-2 x
  max(1, max |JAX|): the integer sums are exact in both, but an
  activation that differs at fp32 noise can round to the neighbouring
  int8 step (one step is absmax / 127 of that layer's input), and a flip
  moves the layer's output by up to a step times a weight column;
* the int8 conv net bitwise: its input is the same array in both, so
  every quantized activation, integer sum and rescale is the same;
* a saved int8 program bitwise the port's eager int8 model (the same
  operator on the same inputs), within the int8 bound above of JAX's
  saved program.
The gpu-marked tests hold Q2 on the card bitwise to its plain version."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import jit
from paddle_tpu_torch import quantization as TQ
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.models import (ErnieConfig,
                                     ErnieForSequenceClassification,
                                     load_reference_arrays)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.layer import Conv2D, Linear
from paddle_tpu_torch.ops import int8_linear as Q2
from paddle_tpu_torch.quantization import int8 as TI

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S = 2, 16
INT8_LOGITS_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _ernie(seed=0):
    """(JAX, port) ERNIE `tiny` classifiers, dropout 0, JAX weights."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import ernie as J
    paddle.seed(seed)
    jm = J.ErnieForSequenceClassification(
        J.ErnieConfig.from_preset("tiny", **NO_DROPOUT), num_classes=2)
    tm = ErnieForSequenceClassification(
        ErnieConfig.from_preset("tiny", **NO_DROPOUT), num_classes=2,
        device="cpu")
    load_reference_arrays(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    return jm, tm


def _ids(seed=1, b=B):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, S))
    labels = rng.integers(0, 2, (b,))
    mask = np.ones((b, S), np.int64)
    mask[-1, S - 5:] = 0
    return ids, labels, mask


def _jt(x):
    import paddle_tpu as paddle
    return paddle.to_tensor(x)


def _jnp(t):
    return np.asarray(t._data)


# ------------------------------------------------------------ fake quant


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quantize_matches_jax_bitwise_with_identity_grad(bits, axis):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from paddle_tpu.quantization import _fake_quant_raw as op
    _fake_quant_raw = op.raw          # the pure jnp function
    rng = np.random.RandomState(bits)
    x = (rng.randn(24, 10) * rng.rand(1, 10) * 3).astype(np.float32)
    g = rng.randn(24, 10).astype(np.float32)
    want = np.asarray(_fake_quant_raw(jnp.asarray(x), bit_length=bits,
                                      channel_axis=axis))
    jgrad = np.asarray(jax.grad(lambda a: jnp.sum(_fake_quant_raw(
        a, bit_length=bits, channel_axis=axis) * g))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = TQ.fake_quantize_abs_max(xt, bits, channel_axis=axis)
    (got * torch.from_numpy(g)).sum().backward()
    assert np.array_equal(got.detach().numpy(), want)
    assert np.array_equal(xt.grad.numpy(), g)
    assert np.array_equal(jgrad, g)
    levels = np.unique(np.round(want / np.abs(want).max(
        axis=None if axis is None else 1 - axis, keepdims=True)
        * (2 ** (bits - 1) - 1)))
    assert len(levels) <= 2 ** bits - 1


def test_quantization_all_holds_the_jax_names():
    pytest.importorskip("jax")
    import paddle_tpu.quantization as JQ
    assert set(JQ.__all__) <= set(TQ.__all__)
    assert all(hasattr(TQ, n) for n in TQ.__all__)
    assert {"quantize_weight", "weight_only_int8", "matmul_wo_int8",
            "quantize_kv_rows", "dequantize_kv"} <= set(TQ.__all__)


# ------------------------------------------------------------ QAT / PTQ


def _jax_loss_and_grads(jm, ids, labels, mask):
    import jax
    import jax.numpy as jnp
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.core.tensor import Tensor, no_grad
    from paddle_tpu.jit.trainer import bind_state, collect_state
    params, _, _ = collect_state(jm)

    def f(p):
        with bind_state(params, p), no_grad():
            logits = jm(Tensor(jnp.asarray(ids)),
                        attention_mask=_jt(mask))
            return JF.cross_entropy(logits,
                                    Tensor(jnp.asarray(labels)))._data, \
                logits._data

    (loss, logits), grads = jax.value_and_grad(f, has_aux=True)(
        {k: t._data for k, t in params.items()})
    return float(loss), np.asarray(logits), {
        k: np.asarray(g, np.float32) for k, g in grads.items()}


def _quanted(model, kind):
    return sorted(n for n, m in (model.named_sublayers() if kind == "jax"
                                 else model.named_modules())
                  if type(m).__name__ == "_QuantedLayer")


@pytest.mark.parametrize("algo", ["QAT", "PTQ"])
def test_qat_forward_grads_and_convert_match_jax(algo):
    """ERNIE `tiny` through `QAT` / `PTQ().quantize` in both packages, the
    second layer's key projection exempted (`add_layer_config(layer,
    None, None)`): the same layers swapped, the logits, the loss and
    every gradient within the fp32 limits; `convert` then unwraps every
    layer and bakes each quantized weight bitwise the JAX function op
    by op (within one ulp of JAX's jitted op), every other parameter
    unchanged."""
    import paddle_tpu.quantization as JQ
    jm, tm = _ernie()
    ids, labels, mask = _ids()
    jcfg, tcfg = JQ.QuantConfig(), TQ.QuantConfig()
    jcfg.add_layer_config(jm.ernie.encoder[1].self_attn.k_proj, None, None)
    tcfg.add_layer_config(tm.ernie.encoder[1].self_attn.k_proj, None, None)
    getattr(JQ, algo)(jcfg).quantize(jm)
    getattr(TQ, algo)(tcfg).quantize(tm)
    swapped = _quanted(tm, "port")
    assert swapped == _quanted(jm, "jax")
    assert len(swapped) == 2 * 6 - 1 + 2     # every Linear but the exempt
    assert type(tm.ernie.encoder[1].self_attn.k_proj) is Linear
    jl, jlogits, jg = _jax_loss_and_grads(jm, ids, labels, mask)
    logits = tm(torch.from_numpy(ids),
                attention_mask=torch.from_numpy(mask))
    loss = TF.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    _close(logits.detach().numpy(), jlogits, 1e-5)
    assert abs(loss.item() - jl) <= 1e-5 * abs(jl)
    tg = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert sorted(tg) == sorted(jg)
    for n in jg:
        if n.endswith("k_proj.bias") or n.endswith("k_proj.inner.bias"):
            continue      # 0 in exact arithmetic (test_torch_ernie.py)
        err = np.abs(tg[n] - jg[n]).max()
        assert err <= 1e-4 * np.abs(jg[n]).max(), (n, err)
    from paddle_tpu.quantization import _fake_quant_raw as op
    before = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    axes = {n: m.channel_axis for n, m in jm.named_sublayers()
            if type(m).__name__ == "_QuantedLayer"}
    getattr(JQ, algo)(jcfg).convert(jm)
    getattr(TQ, algo)(tcfg).convert(tm)
    assert _quanted(tm, "port") == [] == _quanted(jm, "jax")
    jp = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        got = p.detach().numpy()
        wrapper = n[:-len(".weight")]
        if n.endswith(".weight") and wrapper in axes:
            # the JAX function op by op: bitwise; JAX's jitted op: one ulp
            want = np.asarray(op.raw(before[wrapper + ".inner.weight"],
                                     bit_length=8,
                                     channel_axis=axes[wrapper]))
            assert np.array_equal(got, want), n
            assert (np.abs(got - jp[n]) <= np.spacing(np.abs(jp[n]))).all()
        else:
            assert np.array_equal(got, jp[n]), n


def test_type_config_and_custom_quanter():
    """`add_type_config` narrows the swapped kinds; a custom activation
    quanter class is instantiated per layer, as in JAX."""
    _, tm = _ernie()

    class Ident(TQ.BaseQuanter):
        def forward(self, x):
            return x

        def scales(self):
            return None

        def zero_points(self):
            return None

        def quant_axis(self):
            return None

        def bit_length(self):
            return 8

    cfg = TQ.QuantConfig(activation=Ident)
    cfg.add_type_config([Conv2D])
    TQ.QAT(cfg).quantize(tm)
    assert _quanted(tm, "port") == []
    cfg.add_type_config([Linear], activation=Ident)
    TQ.QAT(cfg).quantize(tm)
    q = tm.classifier
    assert type(q).__name__ == "_QuantedLayer" and isinstance(q.act_q, Ident)
    with pytest.raises(TypeError):
        TQ.BaseObserver()


# ------------------------------------------------- quantize_for_inference


def _targets(model, kind, kinds):
    items = (model.named_sublayers() if kind == "jax"
             else model.named_modules())
    return [(n, m) for n, m in items if type(m) in kinds]


def _calib(seed=3, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (B, S)) for _ in range(n)]


def test_calibrated_absmax_and_weights_match_jax():
    """`_collect_absmax` on the same batches: every Linear's input absmax
    within 1e-6 relative; the swapped layers' wq and w_scale bitwise,
    x_scale = absmax / 127 from the same float."""
    import paddle_tpu.nn as jnn
    from paddle_tpu.quantization import int8 as JI
    jm, tm = _ernie()
    calib = _calib()
    jt = _targets(jm, "jax", (jnn.Linear,))
    tt = _targets(tm, "port", (Linear,))
    assert [n for n, _ in jt] == [n for n, _ in tt] and len(tt) == 14
    js = JI._collect_absmax(jm, calib, [m for _, m in jt])
    ts = TI._collect_absmax(tm, calib, [m for _, m in tt])
    for (n, jl), (_, tl) in zip(jt, tt):
        a, b = ts[id(tl)], js[id(jl)]
        assert abs(a - b) <= 1e-6 * b, (n, a, b)
        jq, tq = JI.Int8Linear(jl, b), TI.Int8Linear(tl, b)
        assert np.array_equal(tq.wq.numpy(), _jnp(jq.wq))
        assert np.array_equal(tq.w_scale.numpy(), _jnp(jq.w_scale))
        assert tq.x_scale == jq.x_scale
    jq = JI.quantize_for_inference(jm, calib)
    tq = TI.quantize_for_inference(tm, calib)
    assert tq is tm and not tm.training
    for (n, a), (_, b) in zip(_targets(jq, "jax", (JI.Int8Linear,)),
                              _targets(tq, "port", (TI.Int8Linear,))):
        assert abs(b.x_scale - a.x_scale) <= 1e-6 * a.x_scale, n


def _swap_with(model, kind, stats):
    """Every Linear of `model` swapped for its int8 twin at the given
    absmax (by layer name)."""
    if kind == "jax":
        import paddle_tpu.nn as jnn
        from paddle_tpu.quantization.int8 import Int8Linear as JInt8
        for name, parent in list(model.named_sublayers()) + [("", model)]:
            for child, sub in list(parent._sub_layers.items()):
                full = f"{name}.{child}" if name else child
                if type(sub) is jnn.Linear:
                    parent._sub_layers[child] = JInt8(sub, stats[full])
        return model
    for name, parent in list(model.named_modules()):
        for child, sub in list(parent._modules.items()):
            full = f"{name}.{child}" if name else child
            if type(sub) is Linear:
                parent._modules[child] = TI.Int8Linear(sub, stats[full])
    return model


def _jax_stats(jm):
    import paddle_tpu.nn as jnn
    from paddle_tpu.quantization import int8 as JI
    jt = _targets(jm, "jax", (jnn.Linear,))
    s = JI._collect_absmax(jm, _calib(), [m for _, m in jt])
    return {n: s[id(m)] for n, m in jt}


@pytest.mark.parametrize("masked", [False, True])
def test_int8_logits_match_jax_on_jax_absmax(masked):
    jm, tm = _ernie()
    stats = _jax_stats(jm)
    _swap_with(jm, "jax", stats)
    _swap_with(tm, "port", stats)
    ids, _, mask = _ids(seed=4)
    am = mask if masked else None
    want = _jnp(jm(_jt(ids), attention_mask=None if am is None
                   else _jt(am)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), attention_mask=None if am is None
                 else torch.from_numpy(am)).numpy()
    _close(got, want, INT8_LOGITS_TOL)


def test_layers_filter_and_default_absmax():
    """`layers=` restricts the swap (tests/test_int8.py:119-133); with no
    calibration batches every absmax is 8.0."""
    _, tm = _ernie()
    TI.quantize_for_inference(tm, _calib(n=1), layers=(Conv2D,))
    assert not any(isinstance(m, TI.Int8Linear) for m in tm.modules())
    _, tm2 = _ernie()
    TI.quantize_for_inference(tm2, None, layers=(Linear,))
    q = [m for m in tm2.modules() if isinstance(m, TI.Int8Linear)]
    assert len(q) == 14 and all(m.x_scale == 8.0 / 127.0 for m in q)


# ------------------------------------------------------------- Int8Conv2D


def _conv_nets():
    """tests/test_int8.py's two-conv net in both packages, JAX weights."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu.nn.functional as JF

    class JNet(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.conv1 = jnn.Conv2D(3, 8, 3, padding=1)
            self.conv2 = jnn.Conv2D(8, 4, 3, stride=2, padding=1)
            self.fc = jnn.Linear(4 * 4 * 4, 10)

        def forward(self, x):
            x = JF.relu(self.conv1(x))
            x = JF.relu(self.conv2(x))
            return self.fc(x.reshape([x.shape[0], -1]))

    class TNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = Conv2D(3, 8, 3, padding=1)
            self.conv2 = Conv2D(8, 4, 3, stride=2, padding=1)
            self.fc = Linear(4 * 4 * 4, 10)

        def forward(self, x):
            x = torch.relu(self.conv1(x))
            x = torch.relu(self.conv2(x))
            return self.fc(x.reshape(x.shape[0], -1))

    paddle.seed(0)
    jn, tn = JNet(), TNet()
    load_reference_arrays(tn, {n: np.asarray(p._data)
                               for n, p in jn.named_parameters()})
    return jn, tn


def test_float_conv_net_matches_jax():
    jn, tn = _conv_nets()
    x = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)
    with torch.no_grad():
        got = tn(torch.from_numpy(x)).numpy()
    _close(got, _jnp(jn(_jt(x))), 1e-5)


def test_int8_conv_net_matches_jax_bitwise():
    import paddle_tpu.nn as jnn
    from paddle_tpu.quantization import int8 as JI
    jn, tn = _conv_nets()
    rng = np.random.RandomState(0)
    calib = [rng.rand(2, 3, 8, 8).astype(np.float32) for _ in range(3)]
    kinds = (jnn.Conv2D, jnn.Linear)
    jt = _targets(jn, "jax", kinds)
    js = JI._collect_absmax(jn, calib, [m for _, m in jt])
    stats = {n: js[id(m)] for n, m in jt}
    for name in ("conv1", "conv2"):
        setattr(jn, name, JI.Int8Conv2D(getattr(jn, name), stats[name]))
        setattr(tn, name, TI.Int8Conv2D(getattr(tn, name), stats[name]))
    jn.fc = JI.Int8Linear(jn.fc, stats["fc"])
    tn.fc = TI.Int8Linear(tn.fc, stats["fc"])
    with torch.no_grad():
        got = tn(torch.from_numpy(calib[0])).numpy()
    assert np.array_equal(got, _jnp(jn(_jt(calib[0]))))
    qn = TI.quantize_for_inference(_conv_nets()[1], calib)
    assert isinstance(qn.conv1, TI.Int8Conv2D)
    assert isinstance(qn.fc, TI.Int8Linear)


@pytest.mark.parametrize("padding", ["SAME", "VALID", 2, [1, 2]])
def test_grouped_dilated_int8_conv_matches_jax(padding):
    """A grouped (2), dilated (2, 1), strided conv on a 9 x 10 input
    ("SAME" pads asymmetrically there): the float conv within 1e-5 and
    the int8 conv (the same absmax) bitwise the JAX layers'."""
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.quantization import int8 as JI
    paddle.seed(1)
    jc = jnn.Conv2D(4, 6, (3, 2), stride=(2, 1), padding=padding,
                    dilation=(2, 1), groups=2)
    tc = Conv2D(4, 6, (3, 2), stride=(2, 1), padding=padding,
                dilation=(2, 1), groups=2)
    load_reference_arrays(tc, {n: np.asarray(p._data)
                               for n, p in jc.named_parameters()})
    x = np.random.RandomState(2).randn(2, 4, 9, 10).astype(np.float32)
    want = _jnp(jc(_jt(x)))
    with torch.no_grad():
        got = tc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    _close(got, want, 1e-5)
    absmax = float(np.abs(x).max())
    if isinstance(padding, list):
        return      # the JAX Int8Conv2D takes an int or a string there
    with torch.no_grad():
        got8 = TI.Int8Conv2D(tc, absmax)(torch.from_numpy(x)).numpy()
    assert np.array_equal(got8, _jnp(JI.Int8Conv2D(jc, absmax)(_jt(x))))


def test_conv2d_nhwc_and_int8_state_dict_names():
    """`F.conv2d` in NHWC equals NCHW transposed; the int8 layers' state
    dicts keep the JAX names (`wq`, `w_scale`, `bias`) and a loaded one
    rebuilds Q2's packed weight."""
    g = torch.Generator().manual_seed(0)
    c = Conv2D(3, 5, 3, padding="SAME", generator=g)
    x = torch.randn(2, 3, 7, 6, generator=g)
    a = TF.conv2d(x, c.weight, c.bias, padding="SAME")
    b = TF.conv2d(x.permute(0, 2, 3, 1), c.weight, c.bias, padding="SAME",
                  data_format="NHWC")
    assert torch.allclose(b.permute(0, 3, 1, 2), a, atol=1e-6)
    lin = Linear(70, 9, generator=g)
    q = TI.Int8Linear(lin, 3.0)
    assert sorted(q.state_dict()) == ["bias", "w_scale", "wq"]
    q2 = TI.Int8Linear(Linear(70, 9, generator=g), 3.0)
    q2.load_state_dict(q.state_dict())
    assert torch.equal(q2.wt, q.wt) and q.wt.shape == (9, Q2.K_TILE * 2)
    assert torch.equal(q.wt[:, :70], q.wq.t()) and not q.wt[:, 70:].any()


def test_int8_layers_hold_the_weight_once_and_round_trip_wq():
    """An Int8Linear and a grouped Int8Conv2D hold their int8 weight once,
    as Q2's packed `wt` (no `wq` buffer; `wq` is a view of `wt`): the
    state dict's `wq` is `quantize_weight`'s in the JAX layout, bitwise;
    loaded into a layer built from other weights it is packed back into
    the same `wt` tensor, bitwise; a state dict without `wq` reports it
    missing."""
    g = torch.Generator().manual_seed(1)
    lin = Linear(70, 9, generator=g)
    conv = Conv2D(4, 6, 3, groups=2, generator=g)
    for make, w, axis in ((TI.Int8Linear, lin.weight, 1),
                          (TI.Int8Conv2D, conv.weight, 0)):
        src = lin if make is TI.Int8Linear else conv
        q = make(src, 3.0)
        wq, _ = TI.quantize_weight(w.detach(), axis)
        assert [n for n, _ in q.named_buffers()] == ["wt", "w_scale"]
        assert q.wt.dtype == torch.int8 and q.wt.shape[1] % Q2.K_TILE == 0
        sd = q.state_dict()
        assert sorted(sd) == ["bias", "w_scale", "wq"]
        assert torch.equal(sd["wq"], wq) and torch.equal(q.wq, wq)
        other = make(Linear(70, 9, generator=g) if make is TI.Int8Linear
                     else Conv2D(4, 6, 3, groups=2, generator=g), 3.0)
        held = other.wt
        assert not torch.equal(other.wt, q.wt)
        other.load_state_dict(sd)
        assert other.wt is held and torch.equal(other.wt, q.wt)
        res = other.load_state_dict({k: v for k, v in sd.items()
                                     if k != "wq"}, strict=False)
        assert res.missing_keys == ["wq"] and not res.unexpected_keys


class _Positional(torch.nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, mask):
        return self.m(ids, attention_mask=mask)


def test_int8_ernie_program_holds_each_int8_weight_once(tmp_path):
    """The port's tiny int8 ERNIE (`quantize_for_inference` at the
    default absmax) through jit.save: the `.pt2` program's int8 tensors
    are the 14 quantized layers' packed weights, each once (their bytes
    sum to the layers' `wt` bytes, no `[in, out]` copy among them), and
    the `.pdparams` state dict still carries each `wq` in the JAX
    layout."""
    from paddle_tpu_torch.framework import io as tio
    tm = ErnieForSequenceClassification(
        ErnieConfig.from_preset("tiny", **NO_DROPOUT), num_classes=2,
        device="cpu", seed=0)
    TQ.quantize_for_inference(tm)
    layers = [m for m in tm.modules() if isinstance(m, TI.Int8Linear)]
    assert len(layers) == 14
    path = str(tmp_path / "int8")
    jit.save(_Positional(tm), path,
             input_spec=[jit.InputSpec([None, S], "int64")] * 2)
    program = torch.export.load(path + ".pt2")
    held = [t for t in list(program.state_dict.values())
            + list(program.constants.values())
            if isinstance(t, torch.Tensor) and t.dtype == torch.int8]
    assert sorted(tuple(t.shape) for t in held) == \
        sorted(tuple(m.wt.shape) for m in layers)
    assert sum(t.numel() for t in held) == sum(m.wt.numel() for m in layers)
    params = tio.load(path + ".pdparams")
    wqs = {k: v for k, v in params.items() if k.endswith(".wq")}
    assert len(wqs) == 14
    for k, v in wqs.items():
        layer = tm.get_submodule(k[len("m."):-len(".wq")])
        assert np.array_equal(np.asarray(v), layer.wq.numpy())


@pytest.mark.parametrize("M, K, N, route, splits, xq, ws, sems", [
    (1, 768, 2, "split", 12, None, (2,), (1,)),          # classifier
    (5, 768, 768, "split", 12, None, (3840,), (6,)),      # pooler
    (16, 768, 768, "split", 12, None, (12288,), (6,)),
    (64, 3072, 768, "split", 16, None, (49152,), (6,)),
    (16, 64, 10, "split", 1, None, None, None),          # one K slice
    (3, 147, 64, "split", 3, None, (192,), (1,)),
    (65, 768, 768, "wgmma", 1, (65, 768), None, None),
    (128, 3072, 768, "wgmma", 1, (128, 3072), None, None),   # 1 row
    (640, 768, 3072, "wgmma", 1, (640, 768), None, None),    # 5 rows
    (2048, 768, 3072, "wgmma", 1, (2048, 768), None, None),   # FFN in
    (2048, 3072, 768, "wgmma", 1, (2048, 3072), None, None),  # FFN out
    (401408, 147, 64, "wgmma", 1, (401408, 192), None, None),  # im2col
])
def test_q2_plan_routes_by_rows(M, K, N, route, splits, xq, ws, sems):
    """Q2's route by M (split over K at M <= 64, wgmma above), the split
    count and the scratch each route needs: the wgmma route's (M, Kp)
    int8 xq, the split route's M x N int32 workspace and a semaphore a
    128-column tile (none with one K slice)."""
    p = Q2.plan(M, N, K)
    assert p == Q2.Plan(route, splits, xq, ws, sems)


@pytest.mark.parametrize("rows", [(1, 5, 16, 64), (65, 128, 640, 2048)])
def test_q2_split_counts_fill_the_card_in_whole_tiles(rows):
    """Over the split route's shapes: every slice holds whole 64-wide
    k-tiles and at least one, the count is the one the C side derives
    from it (ceil(kt / ceil(kt / splits))), and column tiles x slices
    stay within the card's 132 SMs unless one slice a tile already
    passes them; above 64 rows the wgmma route, unsplit."""
    for M in rows:
        for K in (1, 63, 64, 65, 147, 768, 1000, 3072, 8192):
            for N in (1, 2, 10, 128, 768, 3072, 20000):
                p = Q2.plan(M, N, K)
                if M > Q2.SMALL_M:
                    assert p == Q2.Plan("wgmma", 1, (M, -(-K // 64) * 64),
                                        None, None)
                    continue
                kt, tiles = -(-K // 64), -(-N // 128)
                per = -(-kt // p.splits)
                assert p.route == "split" and 1 <= p.splits <= kt
                assert -(-kt // per) == p.splits
                assert tiles * p.splits <= max(132, tiles)
                assert (p.workspace is None) == (p.splits == 1)


def test_q2_variants_on_the_cpu():
    """`variant=` takes None (the route by M) or "mma": on a CPU x "mma"
    runs the plain version (bitwise the default), and any other name
    raises, the routes that M picks included, as on the card."""
    rng = np.random.RandomState(7)
    wq, ws = TI.quantize_weight(torch.from_numpy(
        rng.randn(40, 6).astype(np.float32)), 1)
    bias = torch.from_numpy(rng.randn(6).astype(np.float32))
    assert Q2.VARIANTS == ("mma",)
    for M in (3, 70):
        x = torch.from_numpy(rng.randn(M, 40).astype(np.float32))
        want = Q2.int8_linear(x, wq, ws, bias, 0.02)
        for v in Q2.VARIANTS:
            got = Q2.int8_linear(x, None, ws, bias, 0.02,
                                 wt=Q2.pack_weight(wq), variant=v)
            assert torch.equal(got, want), (M, v)
        for bad in ("tiles", "split", "wgmma"):
            with pytest.raises(ValueError, match="variant"):
                Q2.int8_linear(x, wq, ws, bias, 0.02, variant=bad)
    assert torch.equal(Q2.unpack_weight(Q2.pack_weight(wq), 40), wq)


def test_q2_launch_check_takes_only_pack_weights_layout():
    """The check a launch runs first takes `pack_weight`'s wt and refuses
    one padded past K rounded up to 64 (the wgmma route sizes its (M,
    Kp) scratch from K), one of another type and one not contiguous."""
    wq = torch.ones(70, 6, dtype=torch.int8)
    ws, x = torch.ones(6), torch.ones(3, 70)
    Q2._check(x, Q2.pack_weight(wq), ws, None)
    for bad in (torch.zeros(6, 192, dtype=torch.int8),
                Q2.pack_weight(wq).to(torch.int16),
                torch.zeros(128, 6, dtype=torch.int8).t()):
        with pytest.raises(ValueError, match="pack_weight"):
            Q2._check(x, bad, ws, None)


# ------------------------------------------------------------ Q2 (plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_q2_plain_is_the_jax_arithmetic(dtype):
    """Q2's plain version against the JAX `_int8_linear_raw` on the same
    int8 weight and scale: bitwise in fp32; in bf16 / fp16 x is the same
    array in both, so bitwise too."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.quantization.int8 import _int8_linear_raw as op
    _int8_linear_raw = op.raw
    rng = np.random.RandomState(5)
    x = rng.randn(5, 3, 37).astype(np.float32)
    w = rng.randn(37, 11).astype(np.float32)
    bias = rng.randn(11).astype(np.float32)
    wq, ws = TI.quantize_weight(torch.from_numpy(w), 1)
    xs = float(np.abs(x).max()) / 127.0 * 0.7     # some values clip
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(dtype)
    want = np.asarray(_int8_linear_raw(jx, jnp.asarray(wq.numpy()),
                                       jnp.asarray(ws.numpy()),
                                       jnp.asarray(bias), x_scale=xs)
                      .astype(jnp.float32))
    got = Q2.int8_linear(tx, wq, ws, torch.from_numpy(bias), xs)
    assert got.dtype == tx.dtype and got.shape == (5, 3, 11)
    assert np.array_equal(got.float().numpy(), want)


# ---------------------------------------------------- the saved program


def test_int8_ernie_program_holds_q2_and_matches(tmp_path):
    """The int8 ERNIE `tiny` (both packages quantized at JAX's absmax)
    through jit.save -> create_predictor: the port's program holds one
    `paddle_tpu_torch::int8_linear` node a Linear (14) beside K1's two
    `flash_fwd` nodes; its output is bitwise the port's eager int8 model
    at batch 2 and 3, and within the int8 bound of JAX's saved program
    (fixed [2, 16]: the JAX ERNIE cannot save a symbolic batch)."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.inference import Config as JConfig
    from paddle_tpu.inference import create_predictor as jcreate
    from paddle_tpu.jit.api import InputSpec as JSpec

    class JPositional(jnn.Layer):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, ids, mask):
            return self.m(ids, attention_mask=mask)

    class TPositional(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, ids, mask):
            return self.m(ids, attention_mask=mask)

    jm, tm = _ernie()
    stats = _jax_stats(jm)
    _swap_with(jm, "jax", stats).eval()
    _swap_with(tm, "port", stats).eval()
    jpath, tpath = str(tmp_path / "jax_int8"), str(tmp_path / "port_int8")
    paddle.jit.save(JPositional(jm), jpath,
                    input_spec=[JSpec([B, S], "int64")] * 2)
    jit.save(TPositional(tm), tpath,
             input_spec=[jit.InputSpec([None, S], "int64")] * 2)
    program = torch.export.load(tpath + ".pt2")
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert sum("paddle_tpu_torch.int8_linear" in t for t in targets) == 14
    assert sum("paddle_tpu_torch.flash_fwd" in t for t in targets) == 2
    config = Config(tpath)
    config.disable_gpu()
    pred = create_predictor(config)
    for b in (B, 3):
        ids, _, mask = _ids(seed=6, b=b)
        got = pred.run([ids, mask])[0]
        with torch.no_grad():
            eager = tm(torch.from_numpy(ids),
                       attention_mask=torch.from_numpy(mask)).numpy()
        assert np.array_equal(got, eager), b
    ids, _, mask = _ids(seed=6)
    jpred = jcreate(JConfig(jpath))
    want = jpred.run([ids, mask])[0]
    _close(pred.run([ids, mask])[0], want, INT8_LOGITS_TOL)


# ------------------------------------------------------------- the card


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_q2_kernel_matches_its_plain_version_bitwise(dtype):
    """Q2 on the card against its plain version over odd M / N / K (and
    ERNIE's 2,048 x 768 -> 3,072 with a bias, a conv's K 147), on every
    route: the default (split over K at M <= 64, one slice or several;
    wgmma above, at a partial 128-row tile and at N 2 too) and
    `variant="mma"` (the first kernel); launches counted by route; the
    default route again inside a replayed CUDA graph.  Bitwise
    throughout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: Q2 has no CPU or interpret mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    for M, K, N in ((1, 7, 3), (5, 33, 2), (16, 768, 2), (64, 3072, 768),
                    (77, 130, 65), (96, 768, 2), (1000, 147, 64),
                    (2048, 768, 3072),
                    (300, 3072, 768)):
        x = torch.randn(M, K, device="cuda", generator=g).to(dt)
        w = torch.randn(K, N, device="cuda", generator=g)
        wq, ws = TI.quantize_weight(w, 1)
        wt = Q2.pack_weight(wq)
        bias = torch.randn(N, device="cuda", generator=g)
        xs = float(x.float().abs().max()) / 127.0 * 0.9
        p = Q2.plan(M, N, K)
        before = dict(Q2.LAUNCHES)
        got = Q2.int8_linear(x, wq, ws, bias, xs)
        got_nb = Q2.int8_linear(x, None, ws, None, xs, wt)
        mma = Q2.int8_linear(x, None, ws, bias, xs, wt, variant="mma")
        torch.cuda.synchronize()
        moved = {k: Q2.LAUNCHES[k] - before[k] for k in before}
        wg = p.route == "wgmma"
        assert moved == {"int8_linear": 3, "int8_linear_mma": 1,
                         "int8_linear_quant": 2 if wg else 0,
                         "int8_linear_split": 0 if wg else 2}, (M, K, N)
        want = Q2.int8_linear_plain(x, wq, ws, bias, xs)
        want_nb = Q2.int8_linear_plain(x, wq, ws, None, xs)
        assert torch.equal(got, want), (M, K, N, p)
        assert torch.equal(got_nb, want_nb), (M, K, N, p)
        assert torch.equal(mma, want), (M, K, N)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            Q2.int8_linear(x, None, ws, bias, xs, wt)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = Q2.int8_linear(x, None, ws, bias, xs, wt)
        for _ in range(2):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want), (M, K, N, "graph")


@pytest.mark.gpu
def test_q2_split_calls_on_two_streams_at_once():
    """Split calls (M <= 64, several K slices) on two streams at once, and
    a graph of one replayed on a third stream meanwhile: each takes its
    own zeroed workspace, so every output stays bitwise its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: Q2 has no CPU or interpret mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for M, K, N in ((16, 3072, 768), (5, 768, 768), (1, 768, 2)):
        x = torch.randn(M, K, device="cuda", generator=g)
        wq, ws = TI.quantize_weight(torch.randn(K, N, device="cuda",
                                                generator=g), 1)
        bias = torch.randn(N, device="cuda", generator=g)
        xs = float(x.abs().max()) / 127.0 * 0.9
        args = (x, None, ws, bias, xs, Q2.pack_weight(wq))
        assert Q2.plan(M, N, K).splits > 1
        cases.append((args, Q2.int8_linear_plain(x, wq, ws, bias, xs)))
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        Q2.int8_linear(*cases[0][0])
        with torch.cuda.graph(graph, stream=side):
            g_out = Q2.int8_linear(*cases[0][0])
    torch.cuda.current_stream().wait_stream(side)
    streams = [torch.cuda.Stream() for _ in range(3)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = {0: [], 1: []}
    for _ in range(20):
        for i in (0, 1):
            with torch.cuda.stream(streams[i]):
                outs[i] += [Q2.int8_linear(*args) for args, _ in cases]
        with torch.cuda.stream(streams[2]):
            graph.replay()
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    for i in (0, 1):
        for r, out in enumerate(outs[i]):
            assert torch.equal(out, cases[r % 3][1]), (i, r)
    assert torch.equal(g_out, cases[0][1])
