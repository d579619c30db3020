"""The runtime sanitizer (``--sanitize``): checkify's checks in torch.

Port of the ``--sanitize`` half of
``federated_pytorch_test_tpu/analysis/sanitize.py``.  The JAX package runs
every instrumented step under ``jax.experimental.checkify`` with
``float_checks | index_checks`` and throws the error on the host after the
call.  Here a :class:`~torch.utils._python_dispatch.TorchDispatchMode` is
active over each instrumented step (:meth:`Sanitizer.step`), the backward
included, and carries checkify's error as a vector on the step's device:

- **NaN**: after every aten op that is the counterpart of one of
  checkify's NaN primitives (:data:`NAN_OPS`: arithmetic, matmul and
  convolution, reductions, normalisation and pooling, the transcendental
  ops; not allocation, ``full``, ``where`` or copies), "an output holds a
  NaN" is recorded with the op's id if no error is recorded yet;
- **division by zero**: the divisions (:data:`DIV_OPS`, ``reciprocal``
  being torch's ``1 / x``) record a zero in the divisor first, as
  checkify's ``div`` does for any dtype (an integer zero divisor is
  replaced by 1 before the op runs, where the host would raise);
- **out-of-bounds index**: before a gather, scatter, ``index``,
  ``index_select``, ``index_add/copy/fill/put``, ``take``, ``embedding``
  or ``nll_loss`` (its target), the indices are compared with the axis'
  size on the device, an out-of-range index is replaced by 0 before the
  op runs (XLA's gather clamps too), and the first one's (index, axis,
  size) is recorded.  So no out-of-range index reaches a CUDA kernel,
  whose device-side assert would end the CUDA context before the error
  could reach the host; in range, the op sees the same indices;
- **the hand-written kernels**: a ctypes launch is invisible to the mode,
  so each wrapper passes its float outputs to :func:`report`, checked as
  an op named after the kernel.

None of this reads the host inside the step (a divisor or an index that
lies on the host, such as a Python number's wrapped tensor, is read there
directly).  After the step one host read of the error vector raises
:class:`SanitizerError`, naming the step and the op or the index payload:
a sync a step, a debugging mode.  The checks only read values and clamp
no index that is in range, so a sanitized run is bit for bit the run
without.  With ``--sanitize`` off the engines enter no mode.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
)
from torch.utils._pytree import tree_leaves

#: aten ops (overload packets, in-place forms folded in) whose float
#: outputs are NaN-checked: the counterparts of checkify's NaN primitives
#: (``add sub mul div rem pow integer_pow exp expm1 log log1p sqrt rsqrt
#: logistic tanh ... dot_general conv_general_dilated reduce_sum
#: reduce_prod reduce_window cumsum ... pad psum``) and the fused torch ops
#: whose JAX form is a composite of them
NAN_OPS = frozenset("""
add sub rsub mul addcmul addcdiv lerp div true_divide floor_divide
reciprocal remainder fmod pow square sqrt rsqrt exp exp2 expm1 log log1p
log2 log10 sin cos tan tanh sinh cosh asin acos atan atan2 asinh acosh
atanh sigmoid logit erf erfc erfinv lgamma digamma polygamma xlogy
elu softplus gelu silu mish elu_backward softplus_backward
sigmoid_backward tanh_backward gelu_backward silu_backward logit_backward
mm bmm addmm addmv addr mv dot vdot addbmm baddbmm matmul linear
convolution _convolution convolution_backward cudnn_convolution
mkldnn_convolution _slow_conv2d_forward _slow_conv2d_backward
sum mean prod cumsum cumprod logcumsumexp cummax cummin logsumexp var std
var_mean std_mean linalg_vector_norm norm
_softmax _log_softmax _softmax_backward_data _log_softmax_backward_data
nll_loss_forward nll_loss_backward nll_loss2d_forward nll_loss2d_backward
mse_loss mse_loss_backward binary_cross_entropy
binary_cross_entropy_backward binary_cross_entropy_with_logits
native_batch_norm native_batch_norm_backward _native_batch_norm_legit
_native_batch_norm_legit_no_training _native_batch_norm_legit_functional
_batch_norm_with_update _batch_norm_no_update batch_norm_backward
cudnn_batch_norm cudnn_batch_norm_backward native_layer_norm
native_layer_norm_backward native_group_norm native_group_norm_backward
max_pool2d_with_indices max_pool2d_with_indices_backward avg_pool2d
avg_pool2d_backward _adaptive_avg_pool2d _adaptive_avg_pool2d_backward
constant_pad_nd reflection_pad2d replication_pad2d
""".split())

#: divisions: op -> the position of the divisor among its arguments
DIV_OPS: Dict[str, int] = {"div": 1, "true_divide": 1, "floor_divide": 1,
                           "reciprocal": 0}

#: error kinds of the vector [kind, op id, index, axis, size]
NAN, DIV_ZERO, OOB = 1, 2, 3


class SanitizerError(RuntimeError):
    """A sanitized step made a NaN, divided by zero or indexed out of
    bounds.  ``step`` names the step, ``op`` the aten op or kernel,
    ``kind`` one of ``"nan"``, ``"division by zero"``,
    ``"out-of-bounds index"``; ``payload`` is (index, axis, size) for the
    last, else None."""

    def __init__(self, step: str, kind: str, op: str,
                 payload: Optional[Tuple[int, int, int]] = None):
        if kind == "nan":
            what = f"nan generated by op: {op}"
        elif kind == "division by zero":
            what = f"division by zero in op: {op}"
        else:
            i, a, s = payload
            what = (f"out-of-bounds indexing in op: {op}: index {i} is out "
                    f"of bounds for axis {a} with size {s}")
        super().__init__(f"{step}: {what}")
        self.step, self.kind, self.op, self.payload = step, kind, op, payload


_KIND_NAMES = {NAN: "nan", DIV_ZERO: "division by zero",
               OOB: "out-of-bounds index"}


# -- index arguments ---------------------------------------------------
# each returns [(argument position, list slot or None, low, high, axis,
# ignored value or None)]: the index tensor args[pos] (or args[pos][slot])
# must lie in [low, high) on axis ``axis`` unless it equals the ignored
# value


def _axis(t: torch.Tensor, dim: int) -> Tuple[int, int]:
    if t.dim() == 0:
        return 1, 0
    d = dim % t.dim()
    return int(t.shape[d]), d


def _dim_index(args):
    size, d = _axis(args[0], args[1])
    return [(2, None, 0, size, d, None)]


def _index_list(args):
    out = []
    for i, idx in enumerate(args[1]):
        if idx is not None and i < args[0].dim():
            size = int(args[0].shape[i])
            out.append((1, i, -size, size, i, None))
    return out


def _nll(self_pos, target_pos, ignore_pos):
    def spec(args):
        x = args[self_pos]
        classes = int(x.shape[-1] if x.dim() == 1 else x.shape[1])
        ignore = args[ignore_pos] if len(args) > ignore_pos else -100
        return [(target_pos, None, 0, classes, 1 if x.dim() > 1 else 0,
                 ignore)]
    return spec


def _take(args):
    n = args[0].numel()
    return [(1, None, -n, n, 0, None)]


def _embedding(args):
    return [(1, None, 0, int(args[0].shape[0]), 0, None)]


INDEX_OPS: Dict[str, Callable[[Sequence[Any]], list]] = {
    "gather": _dim_index, "scatter": _dim_index, "scatter_add": _dim_index,
    "scatter_reduce": _dim_index, "index_select": _dim_index,
    "index_add": _dim_index, "index_copy": _dim_index,
    "index_fill": _dim_index, "index_reduce": _dim_index,
    "index": _index_list, "index_put": _index_list,
    "_index_put_impl": _index_list,
    "nll_loss_forward": _nll(0, 1, 4), "nll_loss2d_forward": _nll(0, 1, 4),
    "nll_loss_backward": _nll(1, 2, 5), "nll_loss2d_backward": _nll(1, 2, 5),
    "take": _take, "embedding": _embedding,
}

#: OpOverload -> (NaN-checked, divisor position or None, index spec or
#: None), or None for an op the sanitizer passes through
_KINDS: Dict[Any, Optional[tuple]] = {}


def _classify(func) -> Optional[tuple]:
    try:
        return _KINDS[func]
    except KeyError:
        pass
    ns, _, name = func._schema.name.partition("::")
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]                # the in-place form
    kind = None
    if ns == "aten":
        nan = name in NAN_OPS
        div = DIV_OPS.get(name)
        index = INDEX_OPS.get(name)
        if nan or div is not None or index is not None:
            kind = (nan, div, index)
    _KINDS[func] = kind
    return kind


def _is_float(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel() > 0)


class _CheckMode(TorchDispatchMode):
    def __init__(self, sanitizer: "Sanitizer"):
        super().__init__()
        self.sanitizer = sanitizer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.sanitizer._dispatch(func, args, kwargs or {})


#: the sanitizer whose step is running (a module global, not thread-local:
#: the card's autograd runs the backward, and its kernels, on a thread of
#: its own)
_ACTIVE: Optional["Sanitizer"] = None


def report(name: str, *outputs: torch.Tensor) -> None:
    """A hand-written kernel's float outputs, checked for NaN as an op
    named ``kernel <name>`` when a sanitized step is running (else
    nothing)."""
    san = _ACTIVE
    if san is None:
        return
    with _disable_current_modes(), torch.no_grad():
        san._check_nan(f"kernel {name}", outputs)


class Sanitizer:
    """The carried error of the sanitized steps on ``device``."""

    def __init__(self, device):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            # the tensors' own form, so that a check on the card is never
            # taken for a check on the host
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._names: List[str] = []            # op id - 1 -> op name
        self._ids: Dict[str, int] = {}
        self._consts: Dict[tuple, torch.Tensor] = {}
        self._err: Optional[torch.Tensor] = None
        self._host: Optional[Tuple[int, ...]] = None
        self._open = False

    # -- the step ------------------------------------------------------
    @contextlib.contextmanager
    def step(self, label: str):
        """Run the block as one sanitized step named ``label``, then raise
        :class:`SanitizerError` on its first error.  A step opened inside
        a step (the epochs and the comm step of a fused round) is part of
        the outer one."""
        global _ACTIVE
        if self._open:
            yield
            return
        self._open = True
        self._err = torch.zeros(5, dtype=torch.int64, device=self.device)
        self._host = None
        prev, _ACTIVE = _ACTIVE, self
        try:
            with _CheckMode(self):
                yield
        finally:
            _ACTIVE = prev
            self._open = False
        self._throw(label)

    def _throw(self, label: str) -> None:
        vals = self._err.tolist()              # the step's one host read
        if not vals[0]:
            if self._host is None:
                return
            vals = list(self._host)
        kind, op, i, axis, size = vals
        raise SanitizerError(label, _KIND_NAMES[kind], self._names[op - 1],
                             (i, axis, size) if kind == OOB else None)

    # -- recording -----------------------------------------------------
    def _op_id(self, name: str) -> int:
        op = self._ids.get(name)
        if op is None:
            self._names.append(name)
            op = self._ids[name] = len(self._names)
        return op

    def _const(self, *vals: int) -> torch.Tensor:
        t = self._consts.get(vals)
        if t is None:
            t = self._consts[vals] = torch.tensor(vals, dtype=torch.int64,
                                                  device=self.device)
        return t

    def _record(self, cond: torch.Tensor, new: Tuple[int, ...],
                value: Optional[torch.Tensor] = None) -> None:
        """Record ``new`` (with ``value`` as its index) where ``cond`` holds
        and no error is recorded yet.  A ``cond`` on another device than
        the step's (a host tensor inside a step on the card) is read on
        the host, where it lies."""
        if cond.device != self.device:
            if self._host is None and bool(cond):
                new = list(new)
                if value is not None:
                    new[2] = int(value)
                self._host = tuple(new)
            return
        vec = self._const(*new)
        if value is not None:
            vec = vec + value.to(torch.int64) * self._const(0, 0, 1, 0, 0)
        first = cond & (self._err[0] == 0)
        self._err = torch.where(first, vec, self._err)

    def _check_nan(self, name: str, outputs) -> None:
        flags = [torch.isnan(t).any() for t in tree_leaves(outputs)
                 if _is_float(t)]
        if not flags:
            return
        by_dev: Dict[torch.device, List[torch.Tensor]] = {}
        for f in flags:
            by_dev.setdefault(f.device, []).append(f)
        op = self._op_id(name)
        for fl in by_dev.values():
            cond = fl[0] if len(fl) == 1 else torch.stack(fl).any()
            self._record(cond, (NAN, op, 0, 0, 0))

    def _check_div(self, name: str, args, pos: int) -> tuple:
        """Record a zero in ``args[pos]``, the divisor.  An integer zero
        divisor is replaced by 1 before the op runs (the host raises on
        it); a float one divides as IEEE says."""
        divisor = args[pos]
        op = self._op_id(name)
        if isinstance(divisor, torch.Tensor):
            if divisor.numel() == 0 or divisor.is_complex():
                return args
            zero = divisor == 0
            self._record(zero.any(), (DIV_ZERO, op, 0, 0, 0))
            if not divisor.is_floating_point():
                args = list(args)
                args[pos] = torch.where(zero, torch.ones_like(divisor),
                                        divisor)
        elif isinstance(divisor, (int, float)) and divisor == 0:
            self._record(torch.ones((), dtype=torch.bool),
                         (DIV_ZERO, op, 0, 0, 0))
            if isinstance(divisor, int):
                args = list(args)
                args[pos] = 1
        return tuple(args)

    def _check_index(self, name: str, args, spec) -> tuple:
        args = list(args)
        op = None
        for pos, slot, lo, hi, axis, ignore in spec(args):
            idx = args[pos] if slot is None else args[pos][slot]
            if (not isinstance(idx, torch.Tensor) or idx.numel() == 0
                    or idx.dtype in (torch.bool, torch.uint8)
                    or idx.is_floating_point()):
                continue
            oob = (idx < lo) | (idx >= hi)
            if ignore is not None:
                oob = oob & (idx != ignore)
            # in range, the same indices; out of range, index 0
            safe = torch.where(oob, torch.zeros_like(idx), idx)
            flat = oob.reshape(-1)
            first = flat.to(torch.int32).argmax()
            value = idx.reshape(-1)[first]
            if op is None:
                op = self._op_id(name)
            self._record(flat.any(), (OOB, op, 0, axis, hi), value)
            if slot is None:
                args[pos] = safe
            else:
                lst = list(args[pos])
                lst[slot] = safe
                args[pos] = lst
        return tuple(args)

    def _dispatch(self, func, args, kwargs):
        kind = _classify(func)
        if kind is None:
            return func(*args, **kwargs)
        nan, div, index = kind
        name = str(func)
        if index is not None:
            args = self._check_index(name, args, index)
        if div is not None and len(args) > div:
            args = self._check_div(name, args, div)
        out = func(*args, **kwargs)
        if nan:
            self._check_nan(name, out)
        return out


def scope(sanitizer: Optional[Sanitizer], label: str):
    """``sanitizer.step(label)``, or a no-op context without a
    sanitizer."""
    if sanitizer is None:
        return contextlib.nullcontext()
    return sanitizer.step(label)
