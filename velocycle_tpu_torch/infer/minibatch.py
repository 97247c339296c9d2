"""Minibatched and streaming SVI over cell blocks (port of
`velocycle_tpu/infer/minibatch.py`).

Full-batch SVI evaluates the whole genes x cells matrix every step, so the
largest dataset it fits is bounded by device memory.  Here:

  * Cells are split into ``num_blocks`` equal, contiguous blocks, and one
    `MinibatchSVI.update_block` step evaluates one block: on the card one
    `phase_fwdgrad` (or `velo_fwdgrad`) launch over its B = Nc / num_blocks
    cells.
  * Unbiasedness: the cell-local terms (the likelihoods and the per-cell
    ``phi_xy``/``phi`` latents, model and guide sides) are upweighted by
    ``num_blocks`` through `handlers.scale`, which `Trace_ELBO` applies to
    each site's summed log-prob; gene-global terms enter once per step
    unscaled.  The mean of the block losses over one epoch equals the
    full-batch loss at fixed parameters, so each step's gradient is an
    unbiased estimate of the full ELBO's.  On the fused path the likelihood
    site is one scalar whose backward scales the kernel's gradients by the
    incoming cotangent, so the scale reaches them with no kernel change.
  * Block-masked ClippedAdam: a per-cell parameter row (``phixy_locs``,
    ``phi_locs``) and its moments change only when its block is visited,
    bias-corrected with the row's own visit count; global parameters
    update every step.  The hyperparameters are `optim.ClippedAdam`'s.
  * Streaming: `MinibatchSVI.fit_streamed` takes host blocks (numpy or
    memory-mapped arrays, `iter_host_blocks`) and copies each to the card
    from pinned memory on a side stream while the step on the previous
    block runs, so that at most two blocks are on the card at once.
    `MinibatchSVI.fit` splits the device data once (`split_cells`).

The LBA mixture model is refused: its per-gene logsumexp over all cells does
not decompose across blocks.
"""
from __future__ import annotations

import inspect
import warnings

import numpy as np
import torch

from ..core import handlers
from ..models.metapars import PHASE_TENSOR_FIELDS, VELOCITY_TENSOR_FIELDS
from ..parallel.sharding import (
    PARAM_CELL_AXES as _PARAM_CELL_AXES,
    PHASE_CELL_AXES as _PHASE_CELL_AXES,
    VELOCITY_CELL_AXES as _VELOCITY_CELL_AXES,
)
from .elbo import Trace_ELBO
from .svi import constrain, init_params

__all__ = ["MinibatchSVI", "MinibatchState", "split_cells",
           "iter_host_blocks", "init_template", "LOCAL_SITES"]

# model sites whose log-prob is a sum of per-cell terms: the data
# likelihoods and the per-cell latent phase.  Everything else (gene-global
# latents) stays unscaled.
LOCAL_SITES = frozenset(
    {"phi_xy", "phi", "S", "U", "logS", "logU", "S_fused", "SU_fused"}
)


def _is_velocity(data):
    return hasattr(data, "U")


def _cell_axes_for(data):
    return _VELOCITY_CELL_AXES if _is_velocity(data) else _PHASE_CELL_AXES


def _tensor_fields(data):
    return VELOCITY_TENSOR_FIELDS if _is_velocity(data) else PHASE_TENSOR_FIELDS


def _block_lgamma_sum(data, blocks):
    """Each block's own ``sum(lgamma(K + 1))`` over its counts (S, and U in
    the velocity stage), summed in float64 where the counts are and given
    to the kernels in float32, as preprocessing gives the full data's: the
    full data's one constant does not split into blocks."""
    if data.lgamma_k_sum is None:
        return [None] * len(blocks)
    out = []
    for b in blocks:
        counts = (b.S, b.U) if _is_velocity(b) else (b.S,)
        total = sum(torch.lgamma(K.double() + 1.0).sum() for K in counts)
        out.append(total.float())
    return out


def split_cells(data, num_blocks):
    """A PhaseData / VelocityData split into ``num_blocks`` equal blocks
    along the cell axis, each field's block a contiguous copy (the kernels
    take row-major (Ng, B) counts) on the data's device, each block with
    its own ``lgamma_k_sum``.  ``Nc`` must be divisible by ``num_blocks``
    (pad or subset the cells first)."""
    Nc = data.Nc
    if Nc % num_blocks:
        raise ValueError(
            f"Nc={Nc} not divisible by num_blocks={num_blocks}; pad or "
            "subset cells upstream so that every block has one shape"
        )
    B = Nc // num_blocks
    axes = _cell_axes_for(data)
    blocks = []
    for i in range(num_blocks):
        fields = {}
        for name, ax in axes.items():
            leaf = getattr(data, name, None)
            if leaf is None or leaf.dim() <= ax:
                continue
            fields[name] = leaf.narrow(ax, i * B, B).contiguous()
        blocks.append(data.replace(**fields, Nc=B))
    lgs = _block_lgamma_sum(data, blocks)
    return [b.replace(lgamma_k_sum=lg) for b, lg in zip(blocks, lgs)]


def _host_float32(a):
    """A host array as the containers hold it: float64 becomes float32."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def iter_host_blocks(S, count_factor, phixy_prior, template, num_blocks,
                     U=None, logS=None, logU=None, Db=None, D=None,
                     phi_prior=None):
    """Yield ``(block index, block data)`` whose cell-axis fields are HOST
    arrays (numpy or memory-mapped, sliced, not copied), for
    `MinibatchSVI.fit_streamed`; the other fields are ``template``'s.  Each
    block's ``lgamma_k_sum`` is summed on the host in float64 (scipy) when
    the template has one.  Nothing here touches the card: the streamed fit
    owns the copies."""
    from ..preprocessing import _lgamma_k_sum

    Nc = S.shape[1]
    if Nc % num_blocks:
        raise ValueError(f"Nc={Nc} not divisible by num_blocks={num_blocks}")
    B = Nc // num_blocks
    want_lgamma = template.lgamma_k_sum is not None
    is_velo = _is_velocity(template)
    for i in range(num_blocks):
        sl = slice(i * B, (i + 1) * B)
        fields = dict(
            S=S[:, sl],
            count_factor=(count_factor[sl]
                          if np.ndim(count_factor) else count_factor),
            phixy_prior=phixy_prior[sl],
            Nc=B,
        )
        optional = dict(logS=(logS, 1), Db=(Db, 1), phi_prior=(phi_prior, 0))
        if is_velo:
            fields["U"] = U[:, sl]
            optional.update(logU=(logU, 1), D=(D, 1))
        for name, (a, ax) in optional.items():
            if a is not None:
                fields[name] = a[:, sl] if ax == 1 else a[sl]
        if want_lgamma:
            counts = (fields["S"], fields["U"]) if is_velo else (fields["S"],)
            fields["lgamma_k_sum"] = torch.as_tensor(_lgamma_k_sum(*counts))
        yield i, template.replace(**fields)


def init_template(template, Nc, phixy_prior, count_factor=None, Db=None,
                  phi_prior=None, D=None):
    """A full-``Nc`` container for `MinibatchSVI.init` whose count matrices
    never reach the card's memory.

    Initialising the parameters needs only the gene-side priors and the
    static config (``template``'s: a host block from `iter_host_blocks`
    will do) and the full-length per-cell prior fields (host arrays, copied
    to the template's device).  S, logS (and U, logU) become zero-strided
    broadcasts of one zero: no bytes, and the guide never reads them.
    Returns a PhaseData / VelocityData for `MinibatchSVI.fit_streamed`'s
    ``data``."""
    dev = template.mu_nu.device
    Ng = template.Ng

    def to_dev(a):
        return torch.as_tensor(_host_float32(a), device=dev)

    def zeros(*shape, value=0.0, dtype=torch.float32):
        return torch.full((), value, dtype=dtype, device=dev).expand(shape)

    fields = dict(S=zeros(Ng, Nc), Nc=Nc, phixy_prior=to_dev(phixy_prior))
    if template.logS is not None:
        fields["logS"] = zeros(Ng, Nc)
    fields["count_factor"] = (to_dev(count_factor) if count_factor is not None
                              else zeros(Nc))
    if Db is not None:
        fields["Db"] = to_dev(Db)
    elif template.Db is not None:
        fields["Db"] = zeros(template.Db.shape[0], Nc, value=1.0)
    if phi_prior is not None:
        fields["phi_prior"] = to_dev(phi_prior)
    if _is_velocity(template):
        fields["U"] = zeros(Ng, Nc)
        if template.logU is not None:
            fields["logU"] = zeros(Ng, Nc)
        if D is not None:
            fields["D"] = to_dev(D)
        elif template.D is not None:
            fields["D"] = zeros(template.D.shape[0], Nc, value=1.0)
    return template.replace(**fields)


class MinibatchState:
    """(step, params, Adam's two moments, visit counts, key).

    ``params`` are the unconstrained leaf tensors, updated in place.
    ``counts`` holds each parameter's Adam visit counter: an int for a
    global parameter, an int32 tensor of the parameter's shape for a
    cell-axis one, so that bias correction and the lrd decay use each row's
    own visit count (a row first visited at global step 8 is corrected as
    a first visit)."""

    def __init__(self, step, params, mu, nu, counts, key):
        self.step = step
        self.params = params
        self.mu = mu
        self.nu = nu
        self.counts = counts
        self.key = key


class MinibatchSVI:
    """Blockwise SVI: unbiased full-ELBO gradients from one cell block per
    step (the module docstring gives the estimator and the optimizer).

    Args:
      model, guide: the program pair (phase or velocity family).
      num_blocks: the number of cell blocks; ``Nc % num_blocks == 0``.
      lr, betas, eps, clip_norm, lrd: `optim.ClippedAdam`'s.
      loss: the ELBO (default `Trace_ELBO()`).
      local_sites: the cell-local sites (default ``LOCAL_SITES``).
      cell_param_axes: {param name: cell axis} of the per-cell variational
        parameters (default ``phixy_locs`` and ``phi_locs`` on axis 0).
    """

    def __init__(self, model, guide, num_blocks, lr=0.05, betas=(0.80, 0.99),
                 eps=1e-8, clip_norm=10.0, lrd=1.0, loss=None,
                 local_sites=None, cell_param_axes=None):
        self.model = model
        self.guide = guide
        self.num_blocks = num_blocks
        self.lr, self.betas, self.eps = lr, betas, eps
        self.clip_norm, self.lrd = clip_norm, lrd
        self.loss = loss if loss is not None else Trace_ELBO()
        self.local_sites = frozenset(local_sites or LOCAL_SITES)
        self.cell_param_axes = dict(cell_param_axes or _PARAM_CELL_AXES)
        self.constraints = None
        self.block_size = None

    # -- set-up --------------------------------------------------------------
    def init(self, key, data):
        """Full-size parameters from the full data (the per-cell rows cover
        all Nc cells; each block step touches its slice)."""
        if data.Nc % self.num_blocks:
            raise ValueError(
                f"Nc={data.Nc} not divisible by num_blocks={self.num_blocks}"
            )
        if getattr(data, "gene_selection_model", "all") == "lba":
            raise ValueError(
                "MinibatchSVI does not support the LBA mixture model: its "
                "per-gene logsumexp over all cells does not decompose "
                "across cell blocks (models/phase.py phase_model_lba)"
            )
        self.block_size = data.Nc // self.num_blocks
        self._warn_nonlocal_cell_sites(data)
        key_init, key_state = handlers.fold_in(key, 0), handlers.fold_in(key, 1)
        params, self.constraints = init_params(self.guide, key_init, data)
        counts = {
            name: (torch.zeros(p.shape, dtype=torch.int32, device=p.device)
                   if name in self.cell_param_axes else 0)
            for name, p in params.items()
        }
        return MinibatchState(
            0, params, {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()}, counts,
            key_state,
        )

    def _warn_nonlocal_cell_sites(self, data):
        """Guard the unbiasedness: a sample site whose log-prob has a cell
        axis but is not in ``local_sites`` would be counted once per step
        instead of once per epoch, a biased estimate.  Model and guide are
        traced once, on the CPU, on the first n cells, n the least size >= 3
        that no other axis of the data has: a site's log-prob has a cell
        axis where n is among its sizes.  No kernel runs."""
        if int(data.Nc) <= 1:
            return
        axes = _cell_axes_for(data)
        tensors = {f: getattr(data, f) for f in _tensor_fields(data)
                   if getattr(data, f) is not None}
        other = {data.Ng, 2}
        for f, t in tensors.items():
            other.update(d for i, d in enumerate(t.shape) if i != axes.get(f))
        n = next(m for m in range(3, data.Nc + 4) if m not in other)
        if n > data.Nc:
            return     # too few cells to tell the cell axis from the others
        small = data.replace(Nc=n, **{
            f: (t.narrow(axes[f], 0, n) if f in axes and t.dim() > axes[f]
                else t).contiguous().cpu()
            for f, t in tensors.items()})

        def lp_shapes(fn):
            tr = handlers.trace(handlers.seed(fn, 0)).get_trace(small)
            return {name: tuple(site["fn"].log_prob(site["value"]).shape)
                    for name, site in tr.items() if site["type"] == "sample"}

        with torch.no_grad():
            shapes = [lp_shapes(self.model), lp_shapes(self.guide)]
        suspects = sorted({
            name for sh in shapes for name, shape in sh.items()
            if name not in self.local_sites and n in shape
        })
        if suspects:
            warnings.warn(
                f"MinibatchSVI: sample site(s) {suspects} have a cell "
                "log-prob axis but are not in local_sites: the blockwise "
                "objective will be a BIASED full-ELBO estimate.  Pass "
                "local_sites={...} including them if they are per-cell "
                "sites.",
                stacklevel=3,
            )

    # -- one block step ------------------------------------------------------
    def _slice_cell_params(self, params, block_idx):
        B = self.block_size
        return {name: (v if name not in self.cell_param_axes
                       else v.narrow(self.cell_param_axes[name],
                                     block_idx * B, B))
                for name, v in params.items()}

    def _block_loss(self, params, key, block_idx, block_data):
        constrained = constrain(self._slice_cell_params(params, block_idx),
                                self.constraints)
        is_local = self.local_sites.__contains__
        s = float(self.num_blocks)

        def scaled(fn):
            return handlers.scale(fn, scale_factor=s, site_filter=is_local)

        guide = scaled(handlers.substitute(self.guide, data=constrained))
        model = scaled(handlers.substitute(self.model, data=constrained))
        return self.loss.loss(key, model, guide, block_data)

    def _adam(self, p, g, mu, nu, count):
        """One ClippedAdam step of ``p`` and its moments ``mu``, ``nu``, in
        place and in `optim.ClippedAdam`'s arithmetic (whole parameters, or
        views of a block's rows).  ``count`` is the visit count after this
        visit: an int, or a tensor of per-row counts, each row's own bias
        correction and lrd decay."""
        b1, b2 = self.betas
        g = g.clamp(-self.clip_norm, self.clip_norm)
        mu.mul_(b1).add_(g, alpha=1.0 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        if isinstance(count, int):
            upd = (mu / (1.0 - b1 ** count)) / (
                (nu / (1.0 - b2 ** count)).sqrt() + self.eps)
            p.add_(upd, alpha=-self.lr * self.lrd ** (count - 1))
        else:
            c = count.to(g.dtype)
            upd = (mu / (1.0 - torch.pow(b1, c))) / (
                (nu / (1.0 - torch.pow(b2, c))).sqrt() + self.eps)
            p.sub_(upd * (self.lr * torch.pow(self.lrd, c - 1.0)))

    def update_block(self, state, block_idx, block_data):
        """One SVI step on cell block ``block_idx``: (state, loss as a 0-d
        device tensor).  ``state`` is updated in place and returned."""
        block_idx = int(block_idx)
        key, sub = handlers.fold_in(state.key, 0), handlers.fold_in(state.key, 1)
        names = list(state.params)
        loss = self._block_loss(state.params, sub, block_idx, block_data)
        grads = torch.autograd.grad(
            loss, [state.params[n] for n in names], allow_unused=True)
        B = self.block_size
        with torch.no_grad():
            for name, g in zip(names, grads):
                p = state.params[name]
                g = torch.zeros_like(p) if g is None else g
                ax = self.cell_param_axes.get(name)
                if ax is None:
                    state.counts[name] += 1
                    self._adam(p, g, state.mu[name], state.nu[name],
                               state.counts[name])
                else:
                    # block-coordinate Adam: only the block's rows, their
                    # moments and their visit counts move
                    p, g, mu, nu, cnt = (
                        t.narrow(ax, block_idx * B, B) for t in (
                            p, g, state.mu[name], state.nu[name],
                            state.counts[name]))
                    cnt.add_(1)
                    self._adam(p, g, mu, nu, cnt)
        state.step += 1
        state.key = key
        return state, loss.detach()

    # -- drivers -------------------------------------------------------------
    def get_params(self, state):
        with torch.no_grad():
            return {k: v.detach()
                    for k, v in constrain(state.params, self.constraints).items()}

    def fit(self, key, data, num_epochs, shuffle=True, callback=None):
        """Minibatch fit on the card: the blocks split once (`split_cells`),
        then ``num_epochs`` passes over them.  Returns (state, losses as a
        (num_epochs * num_blocks,) numpy array).  The visit order is drawn
        from ``key`` (a different key, another order), with numpy's
        permutation, not the JAX package's.  ``callback(epoch, state, last
        loss)`` after each epoch."""
        state = self.init(key, data)
        blocks = split_cells(data, self.num_blocks)
        rng = np.random.default_rng(handlers.fold_in(key, 0x5B))
        losses = []
        for epoch in range(num_epochs):
            order = (rng.permutation(self.num_blocks) if shuffle
                     else np.arange(self.num_blocks))
            for i in order:
                state, loss = self.update_block(state, int(i), blocks[int(i)])
                losses.append(loss)
            if callback is not None:
                callback(epoch, state, losses[-1])
        return state, torch.stack(losses).cpu().numpy()

    def fit_streamed(self, key, data, block_factory, num_epochs,
                     callback=None):
        """Fit from host blocks: ``block_factory()`` yields ``(block index,
        block data)`` with host arrays (`iter_host_blocks`).  The step on a
        block is queued first; then the next block is read from the factory
        and copied to the card from pinned memory on a side stream while
        that step runs; its own step waits on the copy's event before it
        reads the block, so at most two blocks are on the card.
        On the CPU the same loop makes plain copies.  ``data`` initialises
        the parameters only: build it with `init_template` so that the
        count matrices never reach the card; it has the FULL Nc.

        A factory that takes a positional argument is called as
        ``block_factory(epoch)``, so that it can permute its blocks per
        epoch; one with none streams its own order every epoch."""
        try:
            takes_epoch = any(
                p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                           p.VAR_POSITIONAL)
                for p in inspect.signature(block_factory).parameters.values()
            )  # keyword-only parameters cannot receive the epoch
        except (TypeError, ValueError):
            takes_epoch = False
        state = self.init(key, data)
        dev = next(iter(state.params.values())).device
        stage = _BlockStager(dev)
        losses = []
        for epoch in range(num_epochs):
            it = iter(block_factory(epoch) if takes_epoch else block_factory())
            nxt = next(it, None)
            staged = None if nxt is None else stage.start(*nxt)
            while staged is not None:
                i, block = stage.ready(staged)
                # this step is queued on the card before the next block is
                # read and its copy issued, so that both overlap the step
                state, loss = self.update_block(state, i, block)
                losses.append(loss)
                del block
                nxt = next(it, None)
                staged = None if nxt is None else stage.start(*nxt)
            if callback is not None:
                callback(epoch, state, losses[-1])
        return state, torch.stack(losses).cpu().numpy()


# the host count and field types a block may carry (numpy dtype.str
# without its byte order)
_TORCH_DTYPES = {"i2": torch.int16, "i4": torch.int32, "i8": torch.int64,
                 "f4": torch.float32, "u1": torch.uint8, "b1": torch.bool}


class _BlockStager:
    """Host block -> device block for `MinibatchSVI.fit_streamed`.  On a
    CUDA device each host field is pinned and copied with ``non_blocking``
    on a side stream, and an event marks the end of the block's copies;
    `ready` makes the compute stream wait on that event and records the
    compute stream on the copied tensors (so that their memory is not
    reused before the step has read them).  On the CPU, plain copies."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def _host_fields(self, block):
        """The block's fields not on the device: host arrays (float64 as
        float32) or host tensors."""
        out = {}
        for f in _tensor_fields(block):
            v = getattr(block, f)
            if isinstance(v, torch.Tensor):
                if v.device != self.device:
                    out[f] = v
            elif v is not None:
                out[f] = _host_float32(v)
        return out

    def start(self, i, block):
        host = self._host_fields(block)
        if not self.cuda:
            moved = {f: (v.contiguous() if isinstance(v, torch.Tensor)
                         else torch.from_numpy(np.array(v, order="C")))
                     for f, v in host.items()}
            return int(i), block.replace(**moved), None
        moved = {}
        with torch.cuda.stream(self.stream):
            for f, v in host.items():
                if isinstance(v, torch.Tensor):
                    pinned = v.pin_memory()
                else:   # one host copy, straight into pinned memory
                    pinned = torch.empty(v.shape, pin_memory=True,
                                         dtype=_TORCH_DTYPES[v.dtype.str[1:]])
                    np.copyto(pinned.numpy(), v)
                moved[f] = pinned.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return int(i), block.replace(**moved), (done, list(moved.values()))

    def ready(self, staged):
        i, block, pending = staged
        if pending is not None:
            done, tensors = pending
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            for t in tensors:
                t.record_stream(compute)
        return i, block
