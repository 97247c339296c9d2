"""Effect handlers: the probabilistic-program transforms of the model DSL.

Port of `velocycle_tpu/core/handlers.py` (sample/param/factor/
deterministic/plate, the trace, seed, substitute, condition, replay, block,
scale, enum and uncondition handlers, and `check_plate_shapes`).  A model
is a plain Python function; interpreting it under a handler stack yields a
trace of torch tensors, and autograd records the computation as it runs.

Randomness: `seed` holds one root integer and gives every sample site its
own seed, derived from the root and a stable hash of the site name
(`site_seed`); the site's distribution draws from a `torch.Generator`
seeded with it.  Draws are reproducible for a given root regardless of
site order, but they are not JAX's draws.
"""
from __future__ import annotations

import hashlib

import torch

__all__ = [
    "sample",
    "param",
    "factor",
    "deterministic",
    "plate",
    "trace",
    "seed",
    "substitute",
    "condition",
    "replay",
    "block",
    "scale",
    "enum",
    "uncondition",
    "Trace",
    "fold_in",
    "site_seed",
    "check_plate_shapes",
]

_STACK = []


def _site_hash(name: str) -> int:
    """Stable 31-bit hash of a site name (Python's hash() is salted)."""
    return int.from_bytes(
        hashlib.blake2s(name.encode(), digest_size=4).digest(), "little"
    ) & 0x7FFFFFFF


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and an integer, deterministically."""
    h = hashlib.blake2s(f"{int(seed)}:{int(data)}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & 0x7FFFFFFFFFFFFFFF


def site_seed(root: int, name: str) -> int:
    """The seed `seed` gives the sample site ``name`` under root ``root``."""
    return fold_in(root, _site_hash(name))


class Trace(dict):
    """An ordered dict of site-name -> message dicts."""

    def log_prob_sum(self, site_filter=lambda name, site: True):
        """Sum over the sample sites that ``site_filter(name, site)`` keeps
        of each site's summed log-prob times its scale (`scale`; 1 unless
        a handler set one).  Observed and auxiliary sites count too, as in
        the JAX package (the ELBOs leave auxiliary sites out)."""
        total = 0.0
        for name, site in self.items():
            if site["type"] == "sample" and site_filter(name, site):
                lp = site["fn"].log_prob(site["value"]).sum()
                total = total + lp * site.get("scale", 1.0)
        return total

    def nodes(self):
        """The trace itself (pyro's ``trace.nodes``)."""
        return self


def _apply_stack(msg):
    # outermost handler last in _STACK processes first
    pointer = 0
    for pointer, handler in enumerate(reversed(_STACK)):
        handler.process_message(msg)
        if msg.get("stop"):
            break
    default_process(msg)
    for handler in _STACK[len(_STACK) - pointer - 1:]:
        handler.postprocess_message(msg)
    return msg


def default_process(msg):
    if msg["type"] == "sample" and msg["value"] is None:
        key = msg.get("key")
        if key is None:
            raise RuntimeError(
                f"Site {msg['name']!r} has no value and no seed — wrap the "
                "model in handlers.seed(model, seed)."
            )
        msg["value"] = msg["fn"].sample(key)


def sample(name, fn, obs=None, infer=None):
    """Sample (or observe) a random variable named ``name``."""
    if not _STACK:
        raise RuntimeError(
            "sample() outside of an effect-handler context; wrap the model "
            "with handlers.seed / handlers.trace."
        )
    msg = {
        "type": "sample",
        "name": name,
        "fn": fn,
        "value": obs,
        "is_observed": obs is not None,
        "infer": infer or {},
        "key": None,
        "hidden": False,
    }
    _apply_stack(msg)
    return msg["value"]


def param(name, init=None, constraint=None, event_dim=None):
    """Learnable parameter: under `substitute` the stored value is returned;
    otherwise ``init``.  ``event_dim`` is accepted and ignored, as in the
    JAX package."""
    if not _STACK:
        raise RuntimeError("param() outside of an effect-handler context.")
    msg = {
        "type": "param",
        "name": name,
        "value": None,
        "init": init,
        "constraint": constraint,
        "hidden": False,
    }
    _apply_stack(msg)
    if msg["value"] is None:
        msg["value"] = init if not callable(init) else init()
    return msg["value"]


def factor(name, log_factor):
    """Add ``log_factor`` to the model joint density (an observed Delta
    site whose log_prob is the factor)."""
    from .distributions import Delta

    unit = torch.zeros((), dtype=torch.float32, device=log_factor.device)
    return sample(name, Delta(unit, log_density=log_factor.sum()), obs=unit)


def deterministic(name, value):
    """Record a deterministic quantity in the trace."""
    if not _STACK:
        return value
    msg = {
        "type": "deterministic",
        "name": name,
        "value": value,
        "fn": None,
        "is_observed": True,
        "hidden": False,
    }
    _apply_stack(msg)
    return msg["value"]


class Messenger:
    def __init__(self, fn=None):
        self.fn = fn

    def __enter__(self):
        _STACK.append(self)
        return self

    def __exit__(self, *exc):
        assert _STACK[-1] is self
        _STACK.pop()

    def process_message(self, msg):
        pass

    def postprocess_message(self, msg):
        pass

    def __call__(self, *args, **kwargs):
        with self:
            return self.fn(*args, **kwargs)


class trace(Messenger):
    """Record all sites into a `Trace`."""

    def __enter__(self):
        super().__enter__()
        self.trace = Trace()
        return self

    def postprocess_message(self, msg):
        if msg.get("hidden"):
            return
        if msg["type"] in ("sample", "deterministic", "param"):
            self.trace[msg["name"]] = msg.copy()

    def get_trace(self, *args, **kwargs):
        self(*args, **kwargs)
        return self.trace


class seed(Messenger):
    """Give every sample site a seed derived from one root integer."""

    def __init__(self, fn=None, key=None):
        super().__init__(fn)
        if key is None:
            raise ValueError("seed requires an integer root seed")
        self.key = int(key)

    def process_message(self, msg):
        if msg["type"] == "sample" and msg["key"] is None:
            msg["key"] = site_seed(self.key, msg["name"])


class substitute(Messenger):
    """Fix the values of named sample/param sites."""

    def __init__(self, fn=None, data=None):
        super().__init__(fn)
        self.data = data or {}

    def process_message(self, msg):
        if msg["name"] in self.data and msg["value"] is None:
            msg["value"] = self.data[msg["name"]]


class condition(Messenger):
    """Like substitute, but marks the sites observed."""

    def __init__(self, fn=None, data=None):
        super().__init__(fn)
        self.data = data or {}

    def process_message(self, msg):
        if msg["type"] == "sample" and msg["name"] in self.data:
            msg["value"] = self.data[msg["name"]]
            msg["is_observed"] = True


class replay(Messenger):
    """Reuse sampled values from a previous trace (guide -> model replay)."""

    def __init__(self, fn=None, guide_trace=None):
        super().__init__(fn)
        self.guide_trace = guide_trace

    def process_message(self, msg):
        if (
            msg["type"] == "sample"
            and not msg["is_observed"]
            and msg["name"] in self.guide_trace
        ):
            guide_msg = self.guide_trace[msg["name"]]
            if guide_msg["type"] == "sample":
                msg["value"] = guide_msg["value"]


class block(Messenger):
    """Hide selected sites from outer handlers."""

    def __init__(self, fn=None, hide=None):
        super().__init__(fn)
        self.hide = set(hide or [])

    def process_message(self, msg):
        if msg["name"] in self.hide:
            msg["hidden"] = True


class scale(Messenger):
    """Multiply selected sample sites' log-prob contributions by
    ``scale_factor`` (pyro's ``poutine.scale``): the ELBOs weight each
    site's summed log-prob by its ``msg["scale"]``.  `infer.minibatch`
    upweights the cell-local sites so that each block's loss is an unbiased
    estimate of the full ELBO.  ``site_filter(name)`` selects the sites; by
    default every sample site is scaled."""

    def __init__(self, fn=None, scale_factor=1.0, site_filter=None):
        super().__init__(fn)
        self.scale_factor = scale_factor
        self.site_filter = site_filter

    def process_message(self, msg):
        if msg["type"] != "sample":
            return
        if self.site_filter is not None and not self.site_filter(msg["name"]):
            return
        msg["scale"] = msg.get("scale", 1.0) * self.scale_factor


class enum(Messenger):
    """Parallel enumeration of marked discrete sites.

    A sample site declared with ``infer={"enumerate": "parallel"}`` whose
    value is not already fixed (replay/condition/substitute) takes its
    whole support stacked on a NEW leading axis instead of a draw: the
    j-th enumerated site (in trace order) takes shape ``(K_j,) + (1,)*j +
    batch_shape``, so successive sites broadcast into a joint ``(K_{n-1},
    ..., K_0)`` prefix right-aligned against the model's batch dims.
    `infer.TraceEnum_ELBO` then sums the discrete variables out of the
    model log-joint exactly.
    """

    def __enter__(self):
        super().__enter__()
        self.count = 0
        self._batch_ndim = None
        return self

    def process_message(self, msg):
        if (
            msg["type"] != "sample"
            or msg["is_observed"]
            or msg["value"] is not None
            or msg.get("infer", {}).get("enumerate") != "parallel"
        ):
            return
        support = msg["fn"].enumerate_support()  # (K,) + batch_shape
        K = support.shape[0]
        batch = tuple(support.shape[1:])
        # the (1,)*count prefix forms a correct joint block only when every
        # enumerated site has one batch ndim: differing ndims would collide
        # enum axes with batch axes, so refuse them
        if self._batch_ndim is None:
            self._batch_ndim = len(batch)
        elif len(batch) != self._batch_ndim:
            raise ValueError(
                f"enumerated site {msg['name']!r} has batch ndim "
                f"{len(batch)} but an earlier enumerated site had "
                f"{self._batch_ndim}; give all enumerated sites the same "
                "batch ndim (broadcast their distribution parameters)"
            )
        msg["value"] = support.reshape((K,) + (1,) * self.count + batch)
        msg["infer"]["_enumerated"] = True
        self.count += 1


class plate(Messenger):
    """Named batch dimension; declarative (broadcasting does the work), it
    records (name, size, dim) on each enclosed site's
    ``cond_indep_stack``."""

    def __init__(self, name, size, dim=None):
        super().__init__(None)
        self.name = name
        self.size = size
        self.dim = dim

    def process_message(self, msg):
        msg.setdefault("cond_indep_stack", []).append(
            (self.name, self.size, self.dim)
        )


def check_plate_shapes(fn, *args, key=None, **kwargs):
    """Verify plate/shape consistency of a model or guide.

    Traces ``fn`` (under `seed` with root ``key``, default 0) and checks,
    for every sample site, that

      * each declared plate's ``size`` appears among the site's value
        dimensions (size-1 plates broadcast and always pass), and
      * ``fn.log_prob(value)`` has a shape broadcast-compatible with the
        value's leading dimensions.

    Returns a list of human-readable violation strings (empty = clean).
    """
    tr = trace(seed(fn, 0 if key is None else key)).get_trace(*args, **kwargs)
    problems = []
    for name, site in tr.items():
        if site["type"] != "sample":
            continue
        shape = tuple(torch.as_tensor(site["value"]).shape)
        for pname, size, _dim in site.get("cond_indep_stack", []):
            if size <= 1:
                continue
            if size not in shape:
                problems.append(
                    f"site {name!r}: plate {pname!r} (size {size}) does "
                    f"not appear in value shape {shape}"
                )
        fn_ = site.get("fn")
        if fn_ is not None:
            with torch.no_grad():
                lp_shape = tuple(torch.as_tensor(fn_.log_prob(site["value"])).shape)
            # log_prob batch dims must align with the value's leading dims
            # (event dims are summed out by to_event)
            ok = len(lp_shape) <= len(shape) and all(
                a == b or a == 1 or b == 1 for a, b in zip(lp_shape, shape)
            )
            if not ok:
                problems.append(
                    f"site {name!r}: log_prob shape {lp_shape} does not "
                    f"align with value shape {shape}"
                )
    return problems


def uncondition():
    """A handler that strips observations: every observed sample site is
    drawn again (under `seed`) instead of taking its data, so a model
    generates from its prior predictive."""

    class _Uncondition(Messenger):
        def process_message(self, msg):
            if msg["type"] == "sample" and msg["is_observed"]:
                msg["is_observed"] = False
                msg["value"] = None

    return _Uncondition()
