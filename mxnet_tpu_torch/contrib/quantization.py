"""Model quantization flow: int8 post-training quantization.

Counterpart of ``mxnet_tpu/contrib/quantization.py`` (reference:
python/mxnet/contrib/quantization.py): ``quantize_model`` rewrites a
float Symbol graph, putting ``quantize_v2`` -> ``quantized_conv`` /
``quantized_fully_connected`` -> ``dequantize`` in place of every
``Convolution`` and ``FullyConnected`` node (a dilated convolution and
the ``excluded_sym_names`` stay float), with ``naive`` (min/max) or
``entropy`` (KL-optimal threshold) calibration; ``quantize_net`` is the
Gluon front door (``trace_block`` -> ``quantize_model`` ->
``SymbolBlock``).

The calibration runs the float graph on the device the parameters live
on: one walk of the graph a batch for every insertion point, the ranges
reduced there (``torch.aminmax``), only the entropy mode's bounded
subsample copied to the host, where the KL search (the port's own numpy
copy of the reference's) runs.  Weights and biases are quantized to int8
codes offline on their device, in the JAX package's f32 order, so the
codes are the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError

_QUANTIZABLE = {"Convolution", "FullyConnected"}


def _raw(x):
    """A tensor from an NDArray, a tensor or a numpy array."""
    from ..ndarray.ndarray import NDArray

    if isinstance(x, NDArray):
        return x._data
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


class CalibrationCollector:
    """Collects per-layer activation ranges (reference: the calibration
    pass of quantize_model; 'naive' min/max and percentile modes)."""

    def __init__(self, mode="naive", percentile=99.99):
        assert mode in ("naive", "percentile")
        self.mode = mode
        self.percentile = percentile
        self.ranges = {}

    def collect(self, name, array):
        t = _raw(array).detach()
        if self.mode == "naive":
            lo, hi = (float(v) for v in torch.aminmax(t))
        else:
            a = t.to(torch.float32).cpu().numpy()
            lo = float(_np.percentile(a, 100 - self.percentile))
            hi = float(_np.percentile(a, self.percentile))
        if name in self.ranges:
            plo, phi = self.ranges[name]
            lo, hi = min(lo, plo), max(hi, phi)
        self.ranges[name] = (lo, hi)
        return self.ranges[name]


def _smooth_distribution(p, eps=0.0001):
    """Move ``eps`` mass onto the zero bins so the KL divergence is
    finite, taken in proportion from the nonzero bins (reference:
    _smooth_distribution)."""
    is_zeros = (p == 0).astype(_np.float64)
    is_nonzeros = (p != 0).astype(_np.float64)
    n_zeros = int(is_zeros.sum())
    n_nonzeros = p.size - n_zeros
    if not n_nonzeros:
        return None
    eps1 = eps * n_zeros / n_nonzeros
    hist = p.astype(_np.float64)
    hist += eps * is_zeros + (-eps1) * is_nonzeros
    if (hist <= 0).any():
        return None
    return hist


def _get_optimal_threshold(arr, num_bins=2001, num_quantized_bins=255):
    """The KL-divergence-optimal |threshold| for int8 (reference:
    _get_optimal_threshold, the TensorRT-style entropy calibration).

    The candidate distribution ``p`` has the clipped outlier mass merged
    into its edge bin while ``q`` is built from the unmerged histogram, so
    a threshold that is too small pays for the mass it throws away."""
    a = _np.abs(_np.asarray(arr, dtype=_np.float64).ravel())
    amax = float(a.max()) if a.size else 0.0
    if amax == 0:
        return 1e-8
    hist, edges = _np.histogram(a, bins=num_bins, range=(0, amax))
    hist = hist.astype(_np.float64)

    best_kl, best_t = _np.inf, amax
    step = max(1, (num_bins - num_quantized_bins) // 128)
    for i in range(num_quantized_bins, num_bins + 1, step):
        t = edges[i] if i < len(edges) else amax
        sliced = hist[:i]
        if sliced.sum() == 0:
            continue
        p = sliced.copy()
        p[-1] += hist[i:].sum()  # clipped mass -> edge bin (p only)
        num_merged = i // num_quantized_bins
        qb = _np.add.reduceat(
            sliced[:num_quantized_bins * num_merged],
            _np.arange(0, num_quantized_bins * num_merged, num_merged))
        qb[-1] += sliced[num_quantized_bins * num_merged:].sum()
        q = _np.zeros(i)
        is_nz = sliced != 0
        for j in range(num_quantized_bins):
            lo = j * num_merged
            hi = i if j == num_quantized_bins - 1 else lo + num_merged
            nz = is_nz[lo:hi]
            n = int(nz.sum())
            if n:
                q[lo:hi][nz] = qb[j] / n
        ps = _smooth_distribution(p)
        qs = _smooth_distribution(q)
        if ps is None or qs is None:
            continue
        ps = ps / ps.sum()
        qs = qs / qs.sum()
        kl = float(_np.sum(ps * _np.log(ps / qs)))
        if kl < best_kl:
            best_kl, best_t = kl, t
    return float(best_t)


def _collect_calib_ranges(sym, points, data_names, calib_data,
                          num_calib_examples, calib_mode, params=None):
    """Run the float graph on calibration batches and record the range at
    each quantize-insertion point (reference: collect_layer_output).

    ``naive`` keeps a running (min, max) on the device; ``entropy`` keeps
    a bounded random subsample a point a batch (the same draws as the JAX
    package's: one ``RandomState(0)``, 2^16 indices into the flattened
    activation when it is larger) and runs the KL search on them."""
    from .. import symbol as _sym_mod

    group = _sym_mod.Group([p for _, p in points])
    minmax = {}
    samples = {name: [] for name, _ in points}
    budget = 1 << 16
    rng = _np.random.RandomState(0)
    seen = 0
    env = {k: _raw(v) for k, v in (params or {}).items()}
    device = next(iter(env.values())).device if env else None
    for batch in calib_data:
        x = _raw(batch.data[0] if hasattr(batch, "data") else batch)
        env[data_names[0]] = x if device is None else x.to(device)
        with torch.no_grad():
            outs = group._eval_heads(env)
        bounds = torch.stack([torch.stack(torch.aminmax(o.reshape(-1)))
                              .to(torch.float64) for o in outs]).tolist()
        for (name, _), o, (lo, hi) in zip(points, outs, bounds):
            plo, phi = minmax.get(name, (lo, hi))
            minmax[name] = (min(lo, plo), max(hi, phi))
            if calib_mode == "entropy":
                flat = o.reshape(-1)
                if flat.numel() > budget:
                    idx = torch.from_numpy(
                        rng.randint(0, flat.numel(), budget)).to(flat.device)
                    flat = flat[idx]
                samples[name].append(
                    flat.to(torch.float32).cpu().numpy())
        seen += int(x.shape[0])
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    ranges = {}
    for name, _ in points:
        if name not in minmax:
            continue
        if calib_mode == "entropy":
            t = _get_optimal_threshold(_np.concatenate(samples[name]))
            ranges[name] = (-t, t)
        else:
            ranges[name] = minmax[name]
    return ranges


def _int8_codes(value):
    """A float parameter's int8 codes and |max|, on its device:
    ``clip(round(w * f32(127 / absmax)), -127, 127)`` in f32, the JAX
    package's numpy arithmetic."""
    t = _raw(value).detach().to(torch.float32)
    lo, hi = torch.aminmax(t)
    absmax = float(max(abs(lo.item()), abs(hi.item()), 1e-8))
    scale = torch.tensor(127.0 / absmax, dtype=torch.float32, device=t.device)
    codes = torch.clamp(torch.round(t * scale), -127, 127).to(torch.int8)
    return codes, absmax


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   ctx=None, excluded_sym_names=(), calib_mode="none",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", **kwargs):
    """Rewrite a float Symbol graph for int8 inference (reference:
    quantize_model).

    Returns (qsym, qarg_params, aux_params): Convolution/FullyConnected
    nodes become quantize_v2 -> quantized_* -> dequantize chains, their
    weights and biases int8 codes in qarg_params (beside each weight's
    ``_min``/``_max``), and with calib_mode 'naive'/'entropy' the
    activation quantizers carry static calibrated ranges, so inference
    makes no min/max pass of its own."""
    from .. import symbol as _sym_mod
    from ..context import context_of
    from ..ndarray.ndarray import NDArray
    from ..symbol.symbol import _scalar_sym

    if quantized_dtype != "int8":
        raise MXNetError("quantization supports int8 only")
    if calib_mode not in ("none", "naive", "entropy"):
        raise MXNetError(f"unknown calib_mode {calib_mode}")
    excluded = set(excluded_sym_names or ())
    data_names = ([data_names] if isinstance(data_names, str)
                  else list(data_names))

    topo = sym._topo()
    points = [(node.name, node.inputs[0]) for node in topo
              if _is_quantizable(node, excluded) and node.inputs]

    calib_ranges = {}
    if calib_mode in ("naive", "entropy"):
        if calib_data is None:
            raise MXNetError(f"calib_mode='{calib_mode}' needs calib_data")
        bound = {**(arg_params or {}), **(aux_params or {})}
        calib_ranges = _collect_calib_ranges(
            sym, points, data_names, calib_data, num_calib_examples,
            calib_mode, params=bound)

    def nd_of(t):
        return NDArray(t, context_of(t.device))

    qarg_params = dict(arg_params or {})
    bias_ranges = {}  # bias name -> absmax (shared-bias reuse guard)
    rebuilt = {}      # original node name -> rebuilt Symbol

    def lookup(entry):
        r = rebuilt[entry.name]
        return r[entry.out_index] if entry.out_index else r

    for node in topo:
        if node.op is None:
            v = _sym_mod.var(node.name)
            v.attrs.update(node.attrs)
            v._attr_dict.update(node._attr_dict)
            rebuilt[node.name] = v
            continue
        ins = [lookup(i) for i in node.inputs]
        if not _is_quantizable(node, excluded):
            rebuilt[node.name] = _sym_mod.apply_op(
                node.op, *ins, name=node.name, **node.attrs)
            continue
        data_s = ins[0]
        w_name = node.inputs[1].name
        bias_s = ins[2] if len(ins) > 2 else None
        no_bias = bool(node.attrs.get("no_bias", False)) or bias_s is None

        # offline weight quantization
        w_nd = qarg_params.get(w_name)
        if w_nd is None:
            raise MXNetError(f"quantize_model: missing weight param {w_name}")
        if w_name + "_max" in qarg_params:
            # a weight shared by two quantizable nodes is already int8
            # codes: reuse its stored range, never re-quantize the codes
            w_absmax = float(_raw(qarg_params[w_name + "_max"]).reshape(-1)[0])
        else:
            codes, w_absmax = _int8_codes(w_nd)
            dev = codes.device
            qarg_params[w_name] = nd_of(codes)
            qarg_params[w_name + "_min"] = nd_of(torch.tensor(
                [-w_absmax], dtype=torch.float32, device=dev))
            qarg_params[w_name + "_max"] = nd_of(torch.tensor(
                [w_absmax], dtype=torch.float32, device=dev))
        w_var = rebuilt[w_name]
        wmin = _sym_mod.var(w_name + "_min")
        wmax = _sym_mod.var(w_name + "_max")
        rebuilt.setdefault(w_name + "_min", wmin)
        rebuilt.setdefault(w_name + "_max", wmax)

        qkw = {}
        if node.name in calib_ranges:
            lo, hi = calib_ranges[node.name]
            qkw = {"min_calib_range": lo, "max_calib_range": hi}
        qz = _sym_mod.apply_op("_contrib_quantize_v2", data_s,
                               name=node.name + "_data_quantize", **qkw)
        qdata, dmin, dmax = qz[0], qz[1], qz[2]

        if not no_bias:
            # the bias becomes int8 codes offline (the quantized ops take
            # an int8 bias with its range, as the reference's)
            b_name = node.inputs[2].name
            if b_name in bias_ranges:
                b_absmax = bias_ranges[b_name]
            else:
                codes, b_absmax = _int8_codes(qarg_params.get(b_name))
                qarg_params[b_name] = nd_of(codes)
                bias_ranges[b_name] = b_absmax
            bmin = _scalar_sym(-b_absmax)
            bmax = _scalar_sym(b_absmax)
        op_attrs = {k: v for k, v in node.attrs.items()
                    if k not in ("cudnn_tune", "cudnn_off", "workspace",
                                 "dilate", "layout")}
        qop = ("_contrib_quantized_conv" if node.op == "Convolution"
               else "_contrib_quantized_fully_connected")
        if no_bias:
            qnode = _sym_mod.apply_op(
                qop, qdata, w_var, None, dmin, dmax, wmin, wmax,
                name=node.name + "_quantized", **op_attrs)
        else:
            qnode = _sym_mod.apply_op(
                qop, qdata, w_var, bias_s, dmin, dmax, wmin, wmax,
                bmin, bmax, name=node.name + "_quantized", **op_attrs)
        rebuilt[node.name] = _sym_mod.apply_op(
            "_contrib_dequantize", qnode[0], qnode[1], qnode[2],
            name=node.name + "_dequantize")

    head = rebuilt[sym.name]
    qsym = head[sym.out_index] if sym.out_index else head
    return qsym, qarg_params, dict(aux_params or {})


def _nontrivial_dilate(attrs):
    d = attrs.get("dilate")
    if d is None:
        return False
    if isinstance(d, str):
        d = d.strip("()[] ").replace(",", " ").split()
    if isinstance(d, int):
        d = (d,)
    try:
        return any(int(v) != 1 for v in d)
    except (TypeError, ValueError):
        return True  # unparseable: keep it float


def _is_quantizable(node, excluded):
    """quantized_conv has no dilation: a dilated Convolution stays float
    rather than becoming a non-dilated int8 convolution."""
    if node.op not in _QUANTIZABLE or node.name in excluded:
        return False
    if node.op == "Convolution" and _nontrivial_dilate(node.attrs):
        return False
    return True


def quantize_net(network, calib_data=None, calib_mode="naive",
                 num_calib_examples=None, excluded_sym_names=(),
                 data_shapes=None, **kwargs):
    """Gluon front door (reference: quantize_net): trace the hybridized
    block to a Symbol, rewrite it for int8, and return a SymbolBlock
    running the quantized graph, its parameters on the network's device
    in their own dtypes (int8 codes stay int8)."""
    from .. import symbol as _sym_mod
    from ..gluon.block import SymbolBlock

    sym = _sym_mod.trace_block(network)
    arg_params, aux_params = {}, {}
    for name, p in network.collect_params().items():
        (aux_params if p.grad_req == "null" else arg_params)[name] = \
            p.data()
    qsym, qarg, qaux = quantize_model(
        sym, arg_params, aux_params, calib_mode=calib_mode,
        calib_data=calib_data, num_calib_examples=num_calib_examples,
        excluded_sym_names=excluded_sym_names, **kwargs)
    sb = SymbolBlock(qsym, [_sym_mod.var("data")])
    all_q = {**qarg, **qaux}
    for name, p in sb.params.items():
        if name in all_q:
            value = all_q[name]
            p._load_init(value, value.context, cast_dtype=True,
                         dtype_source="saved")
    return sb


def quantize_block(block, calib_data=None, num_calib_batches=5,
                   calib_mode="naive"):
    """Calibrate a Gluon block for int8 inference and mark it with the
    ranges.  Returns (block, calib_ranges): weights get static ranges
    from their values, the input and output ranges from calibration
    batches."""
    collector = CalibrationCollector(mode=calib_mode)
    for name, param in block.collect_params().items():
        if name.endswith("weight"):
            collector.collect(name, param.data())
    if calib_data is not None:
        count = 0
        for batch in calib_data:
            x = batch.data[0] if hasattr(batch, "data") else batch
            collector.collect("__input__", x)
            out = block(x)
            first = out[0] if isinstance(out, tuple) else out
            collector.collect("__output__", first)
            count += 1
            if count >= num_calib_batches:
                break
    block._quant_ranges = dict(collector.ranges)
    return block, collector.ranges
