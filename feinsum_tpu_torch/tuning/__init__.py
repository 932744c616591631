"""
Autotuning: the parameter-space DSL, transform-space loading and the search
loop, as in ``feinsum_tpu.tuning``.

* :class:`IntParameter`, :class:`BoolParameter`, :class:`TupleParameter`,
  :class:`PermutationParameter` and the ``@transform_param`` /
  ``@einsum_arg`` decorators declare a transform space;
* transform-space modules live in this package's ``tuning/impls`` and are
  loaded by file name (:func:`get_transform_func_from_module_path`); the
  file name is the archive's ``transform_id``;
* :func:`autotune` searches a space by seeded random draws and mutations of
  the best points, validating and timing each point on the device and
  recording it in the archive at once.  It seeds from the archive's rows and
  never measures a configuration twice.
"""

from __future__ import annotations

import importlib.util
import inspect
import logging
import os
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from ..diagnostics import InvalidParameterError, TransformValidationError
from ..einsum import BatchedEinsum

logger = logging.getLogger(__name__)


# {{{ parameter DSL

@dataclass(frozen=True)
class IntParameter:
    """An integer tuning knob in ``[low, high]`` (inclusive)."""

    low: int
    high: int

    def sample(self, rng) -> int:
        return int(rng.integers(self.low, self.high + 1))

    def mutate(self, value, rng) -> int:
        step = max(1, (self.high - self.low) // 8)
        return int(np.clip(value + rng.integers(-step, step + 1),
                           self.low, self.high))

    def contains(self, value) -> bool:
        return isinstance(value, (int, np.integer)) \
            and self.low <= value <= self.high


@dataclass(frozen=True)
class BoolParameter:
    """A boolean tuning knob."""

    def sample(self, rng) -> bool:
        return bool(rng.integers(0, 2))

    def mutate(self, value, rng) -> bool:
        return not value

    def contains(self, value) -> bool:
        return isinstance(value, (bool, np.bool_))


@dataclass(frozen=True)
class TupleParameter:
    """The Cartesian product of sub-parameters."""

    subparams: tuple

    def sample(self, rng) -> tuple:
        return tuple(p.sample(rng) for p in self.subparams)

    def mutate(self, value, rng) -> tuple:
        i = int(rng.integers(0, len(self.subparams)))
        out = list(value)
        out[i] = self.subparams[i].mutate(value[i], rng)
        return tuple(out)

    def contains(self, value) -> bool:
        return (isinstance(value, (tuple, list))
                and len(value) == len(self.subparams)
                and all(p.contains(v)
                        for p, v in zip(self.subparams, value)))


@dataclass(frozen=True)
class PermutationParameter:
    """An axis-permutation knob: values are permutations of
    ``range(ndim)``; a mutation swaps two positions."""

    ndim: int

    def sample(self, rng) -> tuple:
        return tuple(int(v) for v in rng.permutation(self.ndim))

    def mutate(self, value, rng) -> tuple:
        if self.ndim < 2:
            return tuple(value)
        i, j = rng.choice(self.ndim, size=2, replace=False)
        out = list(value)
        out[int(i)], out[int(j)] = out[int(j)], out[int(i)]
        return tuple(out)

    def contains(self, value) -> bool:
        return (isinstance(value, (tuple, list))
                and sorted(int(v) for v in value) == list(range(self.ndim)))


ParameterT = Any  # IntParameter | BoolParameter | TupleParameter | Permutation

# }}}


# {{{ decorators -> ParametrizedTransform

def transform_param(name: str, func: Callable[[BatchedEinsum], ParameterT]):
    """Declare a tuning parameter of the decorated transform; *func* maps the
    einsum to the parameter's space, or to ``None`` where the parameter
    changes nothing on that einsum and is not searched."""
    def wrapper(fn):
        pt = _as_parametrized(fn)
        pt.transform_params[name] = func
        return pt
    return wrapper


def einsum_arg(name: str, func: Callable[[BatchedEinsum], Any]):
    """Declare an argument computed from the einsum itself (e.g. ndof)."""
    def wrapper(fn):
        pt = _as_parametrized(fn)
        pt.einsum_args[name] = func
        return pt
    return wrapper


class ParametrizedTransform:
    """A transform function with its declared einsum arguments and tuning
    parameters."""

    def __init__(self, fn: Callable) -> None:
        self.fn = fn
        self.einsum_args: dict = {}
        self.transform_params: dict = {}

    def get_param_space(self, einsum: BatchedEinsum) -> dict:
        """The searched parameters on *einsum*; a declaration whose function
        gives ``None`` is not searched there (the transform's default
        holds)."""
        space = {name: func(einsum)
                 for name, func in self.transform_params.items()}
        return {name: p for name, p in space.items() if p is not None}

    def bind_args(self, einsum: BatchedEinsum, **params):
        """A ``TransformT`` (program -> program) with everything bound."""
        kwargs = {name: func(einsum)
                  for name, func in self.einsum_args.items()}
        kwargs.update(params)

        def transform(program):
            return self.fn(program, **kwargs)
        return transform

    def __call__(self, program, einsum: Optional[BatchedEinsum] = None,
                 **params):
        e = einsum if einsum is not None else program.einsum
        return self.bind_args(e, **params)(program)


def _as_parametrized(fn) -> ParametrizedTransform:
    if isinstance(fn, ParametrizedTransform):
        return fn
    return ParametrizedTransform(fn)

# }}}


# {{{ impl module loading

IMPLS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "impls")


def get_transform_func_from_module_path(module_path: str
                                        ) -> ParametrizedTransform:
    """``transform`` of a transform-space module: a path, or a file name
    (with or without ``.py``) in this package's ``tuning/impls``."""
    if not module_path.endswith(".py"):
        module_path = module_path + ".py"
    if not os.path.isabs(module_path) and not os.path.exists(module_path):
        module_path = os.path.join(IMPLS_PATH, module_path)
    if not os.path.exists(module_path):
        raise FileNotFoundError(
            f"no transform space {os.path.basename(module_path)!r} in"
            f" {IMPLS_PATH}")
    name = "feinsum_tpu_torch_impl_" + os.path.basename(module_path)[:-3]
    spec = importlib.util.spec_from_file_location(name, module_path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    transform = module.transform
    if not isinstance(transform, ParametrizedTransform):
        raise TypeError(
            f"{module_path}: 'transform' must be decorated with"
            " @transform_param/@einsum_arg")
    return transform

# }}}


# {{{ space flattening (for search and serialization)

def _flatten_space(space: dict) -> list:
    """[(key path, leaf parameter)] in a fixed order."""
    out = []
    for name in sorted(space):
        p = space[name]
        if isinstance(p, TupleParameter):
            for i, sub in enumerate(p.subparams):
                out.append(((name, i), sub))
        else:
            out.append(((name,), p))
    return out


def _config_to_params(space: dict, config: dict) -> dict:
    params = {}
    for name in sorted(space):
        p = space[name]
        if isinstance(p, TupleParameter):
            params[name] = tuple(config[(name, i)]
                                 for i in range(len(p.subparams)))
        else:
            params[name] = config[(name,)]
    return params


def _params_to_config(space: dict, params: dict) -> dict:
    config = {}
    for name in sorted(space):
        p = space[name]
        v = params[name]
        if isinstance(p, TupleParameter):
            for i in range(len(p.subparams)):
                config[(name, i)] = v[i]
        else:
            config[(name,)] = v
    return config


def validate_params_in_space(space: dict, params: dict) -> bool:
    return (set(params) == set(space)
            and all(space[k].contains(v) for k, v in params.items()))


def _freeze(params: dict):
    return tuple(sorted(params.items()))

# }}}


# {{{ autotune

def autotune(einsum: BatchedEinsum, module_path: str, *,
             device=None,
             db_path: Optional[str] = None,
             long_dim_length: int = 100_000,
             stop_after: Optional[float] = None,
             test_limit: Optional[int] = None,
             skip_value_mismatch: bool = False,
             seed: int = 0,
             seed_configs: Optional[list] = None,
             shard: Optional[tuple] = None) -> None:
    """Explore *module_path*'s transform space on *einsum*, recording every
    measured point in the archive *db_path* under *device*'s key.

    *device* is where points run: a CUDA device (``None`` means the current
    card) or ``"cpu"``, whose host timings go under the key ``"cpu"``.  Each
    point is bound, validated against the numpy oracle and timed by
    :func:`~feinsum_tpu_torch.measure.timeit`.  A point whose transform or
    kernel wrapper raises :class:`InvalidParameterError` (a guard) is scored
    infinite and does not count against *test_limit*; a validation mismatch
    raises unless *skip_value_mismatch*.  Any other error propagates: on
    the card it is a fault of this package, not a bad point.

    The search: *seed_configs* first, then, with equal odds once points are
    measured, a mutation of one of the three fastest points or a uniform
    random draw.  The run stops after *test_limit* measured points, after
    *stop_after* seconds, or at 100 points when neither is given.  It seeds
    from the archive's facts for this einsum, device and space (parameters
    the space gained since take their defaults from the transform's
    signature) and never measures a configuration twice.  *shard* =
    ``(index, count)`` splits the random and mutated proposals between
    processes sharing one archive by a hash of the params."""
    from .. import sql_utils
    from ..canonicalization import canonicalize_einsum
    from ..measure import timeit

    if db_path is None:
        db_path = sql_utils.DEFAULT_DB
    einsum = canonicalize_einsum(einsum)
    transform_space = get_transform_func_from_module_path(module_path)
    space = transform_space.get_param_space(einsum)
    flat = _flatten_space(space)
    transform_id = os.path.basename(
        module_path if module_path.endswith(".py") else module_path + ".py")

    rng = np.random.default_rng(seed)
    seen: set = set()
    results: list = []   # (runtime, params)

    sig_defaults = {
        k: p.default for k, p in inspect.signature(
            transform_space.fn).parameters.items()
        if p.default is not inspect.Parameter.empty}

    def _complete(params: dict) -> Optional[dict]:
        missing = set(space) - set(params)
        if missing and not missing <= set(sig_defaults):
            return None
        full = dict(params)
        for k in missing:
            full[k] = sig_defaults[k]
        return full if validate_params_in_space(space, full) else None

    for qinfo in sql_utils.query(einsum, device, db_path=db_path,
                                 err_if_no_results=False):
        params = (_complete(dict(qinfo.transform_params))
                  if qinfo.transform_id == transform_id else None)
        if params is not None:
            seen.add(_freeze(params))
            results.append((qinfo.runtime_in_sec, params))
            logger.info("archive seed: %s -> %.3es", params,
                        qinfo.runtime_in_sec)

    pending = [dict(c) for c in (seed_configs or [])
               if validate_params_in_space(space, dict(c))]

    def in_shard(params: dict) -> bool:
        if shard is None:
            return True
        idx, count = shard
        return zlib.crc32(repr(_freeze(params)).encode()) % int(count) \
            == int(idx)

    def propose() -> tuple:
        if pending:
            return ("pending", pending.pop(0))
        if results and rng.random() < 0.5:
            best = sorted(results, key=lambda rp: rp[0])[:3]
            _, base = best[int(rng.integers(0, len(best)))]
            cfg = _params_to_config(space, base)
            key, p = flat[int(rng.integers(0, len(flat)))]
            cfg[key] = p.mutate(cfg[key], rng)
            return ("search", _config_to_params(space, cfg))
        return ("search", {name: p.sample(rng) for name, p in space.items()})

    t_start = time.time()
    n_tested = n_invalid = n_mismatch = 0
    while True:
        if stop_after is not None and time.time() - t_start > stop_after:
            break
        if test_limit is not None:
            # guard rejections are free; a hard cap on draws still ends a
            # run in a space the guards reject entirely
            if n_tested - n_invalid >= test_limit \
                    or n_tested >= 40 * test_limit + 64:
                break
        if stop_after is None and test_limit is None and n_tested >= 100:
            break
        params = None
        for _attempt in range(64):
            kind, cand = propose()
            if _freeze(cand) in seen:
                continue
            if kind == "search" and not in_shard(cand):
                continue
            params = cand
            break
        if params is None:
            logger.info("search space exhausted (or all known)")
            break
        seen.add(_freeze(params))
        n_tested += 1
        try:
            runtime = timeit(
                einsum, transform=transform_space.bind_args(einsum, **params),
                long_dim_length=long_dim_length, device=device)
        except InvalidParameterError as err:
            logger.info("invalid point %s: %s", params, err)
            n_invalid += 1
            results.append((float("inf"), params))
            continue
        except TransformValidationError as err:
            if not skip_value_mismatch:
                raise
            logger.warning("validation mismatch %s: %s", params, err)
            n_mismatch += 1
            results.append((float("inf"), params))
            continue
        results.append((runtime, params))
        sql_utils.record_facts(
            einsum, transform_id=transform_id, transform_params=params,
            runtime_in_sec=runtime, device=device, db_path=db_path,
            long_dim_length=long_dim_length)
        logger.info("measured %s -> %.3es", params, runtime)

    logger.info("autotune: %d points tested: %d measured, %d invalid,"
                " %d validation mismatches", n_tested,
                n_tested - n_invalid - n_mismatch, n_invalid, n_mismatch)

# }}}
