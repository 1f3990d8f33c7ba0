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
    ERNIE's 2,048 x 768 -> 3,072 with a bias): bitwise, launches
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: Q2 has no CPU or interpret mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    for M, K, N in ((1, 7, 3), (5, 33, 2), (16, 768, 2), (77, 130, 65),
                    (2048, 768, 3072), (300, 3072, 768)):
        x = torch.randn(M, K, device="cuda", generator=g).to(dt)
        w = torch.randn(K, N, device="cuda", generator=g)
        wq, ws = TI.quantize_weight(w, 1)
        bias = torch.randn(N, device="cuda", generator=g)
        xs = float(x.float().abs().max()) / 127.0 * 0.9
        before = Q2.LAUNCHES["int8_linear"]
        got = Q2.int8_linear(x, wq, ws, bias, xs)
        got_nb = Q2.int8_linear(x, wq, ws, None, xs)
        torch.cuda.synchronize()
        assert Q2.LAUNCHES["int8_linear"] == before + 2
        want = Q2.int8_linear_plain(x, wq, ws, bias, xs)
        want_nb = Q2.int8_linear_plain(x, wq, ws, None, xs)
        assert torch.equal(got, want), (M, K, N)
        assert torch.equal(got_nb, want_nb), (M, K, N)
