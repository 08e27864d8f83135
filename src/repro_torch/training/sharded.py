"""One training step over the grid (FSDP x TP): the counterpart of the
reference's ``train_step`` jitted with ``--mesh``'s shardings.

GSPMD runs the reference's step as one device would under the same
padding plan; this module runs the same function over the workers of a
``launch.mesh.Grid``, each holding its own shard of every weight and
moment (``launch.sharding.place`` of ``param_pspecs(..., fsdp=True)``),
with every exchange an autograd function of the grid:

* **batch**: worker (pod, data, model) holds the rows of its batch
  shard (pod and data), the same rows on every worker of a model group;
  the loss is the cross-entropy summed over every shard's tokens over
  the global token count, plus the MoE load-balance loss of the whole
  batch;
* **FSDP**: each block gathers its data-sharded leaves over ``data``
  before use (inside the block's activation checkpoint, so they are
  gathered again in the recompute and no full copy outlives the block);
  autograd sums their gradients back into the owners' shards (the
  reduce-scatter);
* **TP** over ``model``: attention by heads (``wq`` / ``wk`` / ``wv``
  columns, ``wo`` rows: the reference's contiguous chunks are whole
  heads; kv heads that the plan replicates are gathered over the group
  and each worker takes the heads its kv slots copy), the dense MLP
  (``wi`` columns, ``wo`` rows; a gated ``wi``'s contiguous chunks are
  re-laid by an all-to-all inside the group into each worker's
  ``[gate | up]`` shard, ``core.instance.shard_mlp``'s layout), and MoE
  experts over ``model`` (expert mode ``model``); each ends in an
  all-reduce-sum of the partial outputs.  Every other leaf split over
  ``model`` (the recurrent mixers, the router, an encoder, a vision
  projection, MoE experts in another mode) is gathered over the group
  and its part runs whole on every worker;
* **vocabulary**: ``embed`` rows and ``lm_head`` columns over ``model``:
  each worker looks up the tokens of its rows (an all-reduce-sum joins
  them) and the cross-entropy is vocab-parallel (the max, the sum of
  exponentials and the label's logit all-reduced over the group);
* **MoE routing** is global, as in the reference's ``--mesh`` run: each
  worker routes its rows, the top-k choices are all-gathered over the
  batch axes, and the capacity and buffer positions are counted over
  every shard's tokens in global order.  Under ``hints(moe_blocks=n)``
  they are counted in n blocks, and no exchange is needed when each
  block lies inside one shard;
* **AdamW** updates every worker's shard in place with fp32 moments
  placed like the weights.  The gradients of a leaf's copies (a
  replicated leaf, or a shard held by several workers) are summed over
  the workers that hold them first, so the copies stay bit-equal; the
  global-norm clip counts every logical element once (one owner a
  shard).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.instance import check_degree, kv_heads_of
from repro_torch.core.padding import PaddingPlan
from repro_torch.launch import sharding as SH
from repro_torch.launch.comm_analysis import TALLY
from repro_torch.launch.mesh import Grid, batch_axes, spec_axes
from repro_torch.models import blocks as B
from repro_torch.models import layers as Lyr
from repro_torch.models.convert import REC_KEYS
from repro_torch.models.model import (PAGE_TOKENS, Model, cross_after,
                                      encode_cross_kv, run_encoder,
                                      tree_of, vocab_mask, with_patches)
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_step import AUX_WEIGHT

Shards = Dict[str, List[torch.Tensor]]

MODEL = "model"


def split_batch(batch: Dict[str, torch.Tensor], grid: Grid
                ) -> List[Dict[str, torch.Tensor]]:
    """Each worker's rows of ``batch`` (``batch_pspecs``: the batch dim
    over pod and data), on its device."""
    axes = batch_axes(grid)
    n = grid.extent(axes)
    if any(v.shape[0] % n for v in batch.values()):
        raise ValueError(f"a batch of {batch['tokens'].shape[0]} rows does "
                         f"not split over the {n} batch shards of {axes}")
    specs = SH.batch_pspecs(batch, grid, axes)
    out = []
    for w, dev in enumerate(grid.devices):
        out.append({k: v[tuple(SH.shard_slices(v.shape, specs[k], grid, w))]
                    .to(dev, copy=True) for k, v in batch.items()})
    return out


class ShardedStep:
    """The forward, loss and update of one training step over ``grid``:
    ``shards`` (name -> one tensor a worker, each a leaf with gradients
    on) placed by ``specs``; ``plan`` the lane plan of the model axis
    (``make_plan(cfg, M, "lane")``, its gated MLPs in the per-shard
    Eq. 2 layout).  Every block runs under activation checkpointing, as
    the reference's ``--mesh`` step does; ``banded``: a windowed
    layer's attention computes only its band (``layers.
    banded_attention``) where the reference's would."""

    def __init__(self, cfg: ModelConfig, plan: PaddingPlan, grid: Grid,
                 specs: Dict[str, SH.Spec], shards: Shards,
                 banded: bool = False):
        self.cfg, self.plan, self.grid = cfg, plan, grid
        self.specs, self.shards = specs, shards
        self.banded = banded
        self.M = grid.shape[MODEL]
        self.baxes = batch_axes(grid)
        check_degree(plan, self.M)
        self.mpos = [grid.position(w, (MODEL,)) for w in range(grid.W)]

    @classmethod
    def from_model(cls, model: Model, grid: Grid, expert_mode: str = "auto",
                   banded: bool = False) -> "ShardedStep":
        """The step over ``grid`` with ``model``'s weights copied out
        into shards placed by ``param_pspecs(..., fsdp=True)`` (the
        reference's ``--mesh`` placements, MoE experts in
        ``expert_mode``).  ``model``: the logical model under the lane
        plan of the grid's model axis, its MLPs in the per-shard layout
        (on any device, meta included)."""
        params = dict(model.named_parameters())
        specs = SH.param_pspecs(params, model.cfg, model.plan, fsdp=True,
                                data_size=grid.shape["data"],
                                expert_mode=expert_mode)
        return cls(model.cfg, model.plan, grid, specs,
                   SH.place(params, specs, grid, requires_grad=True),
                   banded=banded)

    # -- leaves --------------------------------------------------------------
    def _gather(self, name: str, axes: Tuple[str, ...],
                xs: Optional[List[torch.Tensor]] = None
                ) -> List[torch.Tensor]:
        """Leaf ``name``'s shards (or ``xs``) gathered over the dims its
        placement splits over any of ``axes``."""
        xs = self.shards[name] if xs is None else xs
        for dim, entry in enumerate(self.specs[name]):
            names = spec_axes(entry)
            if names and set(names) <= set(axes):
                xs = self.grid.all_gather(xs, names, dim)
            elif set(names) & set(axes):
                raise NotImplementedError(f"{name}: {self.specs[name]}")
        return xs

    def full(self, name: str) -> List[torch.Tensor]:
        """Every worker's copy of the whole leaf."""
        return self._gather(name, self.grid.axis_names)

    def tp(self, name: str) -> List[torch.Tensor]:
        """Every worker's model shard of the leaf (gathered over the
        other axes)."""
        return self._gather(name, tuple(a for a in self.grid.axis_names
                                        if a != MODEL))

    def _model_dim(self, name: str) -> Optional[int]:
        for dim, entry in enumerate(self.specs[name]):
            if MODEL in spec_axes(entry):
                return dim
        return None

    def _split(self, name: str, dim: int) -> bool:
        """Whether leaf ``name`` is split over ``model`` on ``dim`` (and
        the model axis has more than one worker)."""
        return self.M > 1 and self._model_dim(name) == dim

    # -- sub-layers -----------------------------------------------------------
    def _attention(self, pre: str, hs, poss, window: int
                   ) -> List[torch.Tensor]:
        g, plan = self.grid, self.plan
        names = [pre + k for k in ("wq", "wk", "wv", "wo")]
        tp = (self._split(names[0], 1) and self._split(names[3], 0))
        if not tp:
            ws = {k: self.full(n) for k, n in zip("qkvo", names)}
            return [B.attention_train(
                {"w" + k: ws[k][w] for k in "qkvo"}, hs[w], self.cfg, plan,
                poss[w], window=window, banded=self.banded)
                for w in range(g.W)]
        wq, wo = self.tp(names[0]), self.tp(names[3])
        if plan.kv_replication == 1:
            wk, wv = self.tp(names[1]), self.tp(names[2])
        else:
            # a kv head copied to several positions: each takes its own
            dh = self.cfg.resolved_head_dim
            wk, wv = self.full(names[1]), self.full(names[2])
            heads = [kv_heads_of(plan, self.M, p) for p in self.mpos]
            wk = [x[:, lo * dh:hi * dh] for x, (lo, hi) in zip(wk, heads)]
            wv = [x[:, lo * dh:hi * dh] for x, (lo, hi) in zip(wv, heads)]
        outs = [B.attention_train({"wq": wq[w], "wk": wk[w], "wv": wv[w],
                                   "wo": wo[w]}, hs[w], self.cfg, plan,
                                  poss[w], window=window,
                                  banded=self.banded)
                for w in range(g.W)]
        return g.all_reduce_sum(outs, MODEL)

    def _mlp_shard(self, wi_name: str, wo_name: str
                   ) -> Optional[Tuple[List, List]]:
        """Each worker's TP shard of a dense MLP, or None when the
        placement does not split it Megatron-style over ``model``."""
        if not (self._split(wi_name, 1) and self._split(wo_name, 0)):
            return None
        wi = self.shards[wi_name]
        if self.cfg.activation in ("swiglu", "geglu"):
            M, s = self.M, self.plan.d_ff_padded // self.M

            def pieces(i: int):
                return [(i // 2, (i % 2) * s, s),
                        ((M + i) // 2, ((M + i) % 2) * s, s)]
            wi = self.grid.all_to_all(wi, MODEL, 1, pieces)
        axes = tuple(a for a in self.grid.axis_names if a != MODEL)
        return self._gather(wi_name, axes, wi), self.tp(wo_name)

    def _dense(self, pre: str, hs, prefix: str = "") -> List:
        """(outputs, partial): a dense MLP's outputs, partial sums of a
        TP group when ``partial``."""
        wi_n, wo_n = pre + prefix + "wi", pre + prefix + "wo"
        act = self.cfg.activation
        sh = self._mlp_shard(wi_n, wo_n)
        if sh is None:
            wi, wo = self.full(wi_n), self.full(wo_n)
            return [Lyr.dense_mlp(h, wi[w], wo[w], act)
                    for w, h in enumerate(hs)], False
        wi, wo = sh
        return [Lyr.dense_mlp(h, wi[w], wo[w], act)
                for w, h in enumerate(hs)], True

    def _moe(self, pre: str, hs) -> Tuple[List, torch.Tensor]:
        """A MoE layer's outputs and its load-balance loss (on worker
        0's device)."""
        g, cfg, plan = self.grid, self.cfg, self.plan
        d, Ep = cfg.d_model, plan.experts_padded
        router = self.full(pre + "router")
        xts = [h.reshape(-1, d) for h in hs]
        gates = [B.moe_gates(router[w], x, plan) for w, x in enumerate(xts)]
        routes = [B.moe_route(router[w], x, cfg, plan, gates[w])
                  for w, x in enumerate(xts)]
        Td = xts[0].shape[0]
        T, nb, cap, rows = self.moe_dispatch(Td)
        Tb = T // nb
        if Td % Tb == 0:
            # every block inside one shard: block-local, no exchange
            pos = [B.moe_positions(ti, Ep, cap, Td // Tb)
                   for _, ti in routes]
        else:
            # the global positions decide which choices are kept; each
            # worker's kept choices then fill a buffer of its own rows
            # (dropped ones counted on a spare expert Ep, every count
            # inside its capacity)
            every = g.all_gather([ti.to(torch.int32) for _, ti in routes],
                                 self.baxes, 0)
            pos = []
            for w, (e, (_, ti)) in enumerate(zip(every, routes)):
                _, keep = B.moe_positions(e.long(), Ep, cap, nb)
                b = g.position(w, self.baxes)
                keep = keep[b * Td:(b + 1) * Td]
                slot, _ = B.moe_positions(torch.where(keep, ti, Ep), Ep + 1,
                                          ti.numel())
                pos.append((slot, keep))
        ep = self._split(pre + "wi", 0) and self._split(pre + "wo", 0)
        if ep:
            wi, wo = self.tp(pre + "wi"), self.tp(pre + "wo")
        else:
            wi, wo = self.full(pre + "wi"), self.full(pre + "wo")
        outs = []
        for w, (x, (topv, topi), (slot, keep)) in enumerate(
                zip(xts, routes, pos)):
            if ep:
                n = Ep // self.M
                lo = self.mpos[w] * n
                mine = (topi >= lo) & (topi < lo + n)
                keep, topi = keep & mine, torch.where(mine, topi - lo, 0)
            outs.append(B.moe_experts({"wi": wi[w], "wo": wo[w]}, x, topv,
                                      topi, slot, keep, rows,
                                      cfg.activation).reshape(hs[w].shape))
        shared, partial = (self._dense(pre, hs, "shared_")
                           if pre + "shared_wi" in self.shards
                           else (None, False))
        if shared is not None and partial == ep:
            outs = [y + s for y, s in zip(outs, shared)]
            shared = None
        if ep:
            outs = g.all_reduce_sum(outs, MODEL)
        if shared is not None:
            if partial:
                shared = g.all_reduce_sum(shared, MODEL)
            outs = [y + s for y, s in zip(outs, shared)]
        # the load-balance loss over the whole batch
        first = [w if self.mpos[w] == 0 else None for w in range(g.W)]
        stats = [None if f is None else torch.stack([
            torch.nn.functional.one_hot(routes[w][1][:, 0], Ep).float()
            .sum(0), gates[w].sum(0)]) for w, f in enumerate(first)]
        tot = g.all_reduce_sum(stats, self.baxes)[0]
        E = plan.num_experts
        aux = ((tot[0] / T) * (tot[1] / T)).sum() * (E ** 2) / max(E, 1)
        return outs, aux

    def moe_dispatch(self, Td: int) -> Tuple[int, int, int, int]:
        """(T, nb, cap, rows) of a MoE layer over batch shards of ``Td``
        tokens: the batch's tokens, the reference's blocks and capacity
        a block (``nb * cap`` rows an expert in its buffer), and the rows
        an expert's buffer has on a worker: its blocks' when every block
        lies inside one shard, else at most one a token of its shard
        (a token picks an expert once), at most ``nb * cap``."""
        T = Td * self.grid.extent(self.baxes)
        nb = B.moe_blocks(T)
        cap = B.moe_capacity(T // nb, self.cfg)
        local = Td % (T // nb) == 0
        return T, nb, cap, (Td // (T // nb) * cap if local
                            else min(nb * cap, Td))

    def _block(self, li: int, kind: str, poss, *xs):
        """Block ``li`` on every worker's rows: ``blocks.train_block``'s
        skeleton over one tensor a worker."""
        cfg, pre = self.cfg, f"layers.{li}."

        def norm(hs, name):
            ln = self.full(pre + name)
            return [Lyr.rmsnorm(h, ln[w], cfg.norm_eps)
                    for w, h in enumerate(hs)]

        def mixer(hs):
            if kind not in B.RECURRENT_KINDS:
                return self._attention(pre + "attn.", hs, poss,
                                       B._window_of(kind, cfg))
            mix = {k: self.full(pre + "rec." + k) for k in REC_KEYS[kind]}
            return [B.rec_train(kind, {k: v[w] for k, v in mix.items()}, h,
                                PAGE_TOKENS) for w, h in enumerate(hs)]

        def mlp(hs):
            if kind == B.MOE:
                return self._moe(pre + "mlp.", hs)
            outs, partial = self._dense(pre + "mlp.", hs)
            return (self.grid.all_reduce_sum(outs, MODEL) if partial
                    else outs), None
        ys, aux = B.train_block(kind, list(xs), norm, mixer, mlp,
                                add=lambda a, b: [x + y
                                                  for x, y in zip(a, b)])
        return tuple(ys), aux

    # -- the model ------------------------------------------------------------
    def _embed(self, parts: List[Dict[str, torch.Tensor]]):
        g, cfg = self.grid, self.cfg
        toks = [p["tokens"][:, :-1].long() for p in parts]
        if self._split("embed", 0):
            emb = self.tp("embed")
            n = emb[0].shape[0]
            xs = []
            for w, (e, t) in enumerate(zip(emb, toks)):
                local = t - self.mpos[w] * n
                inr = (local >= 0) & (local < n)
                xs.append(e[local.clamp(0, n - 1)] * inr[..., None].to(e.dtype))
            xs = g.all_reduce_sum(xs, MODEL)
        else:
            emb = self.full("embed")
            xs = [e[t] for e, t in zip(emb, toks)]
        if "patches" in parts[0]:
            vp = self.full("vision_proj")
            xs = [with_patches(x, cfg, p["patches"], vp[w])
                  for w, (p, x) in enumerate(zip(parts, xs))]
        return xs

    def _cross_memory(self, parts):
        """Each worker's (cross weights of every group, their keys and
        values over its encoder output): the encoder and cross weights
        whole on every worker."""
        cfg, plan = self.cfg, self.plan
        named = {n: self.full(n) for n in self.shards
                 if n.startswith(("encoder.", "cross."))}
        mems = []
        for w, p in enumerate(parts):
            tree = tree_of({n: v[w] for n, v in named.items()})
            out = run_encoder(tree["encoder"], cfg, plan, p["frames"],
                              train=True)
            mems.append((tree["cross"],
                         encode_cross_kv(tree["cross"], cfg, plan, out)))
        return mems

    def _head_loss(self, xs, parts):
        """The vocab-parallel cross-entropy: each worker's per-token nll
        of its rows (equal copies across its model group)."""
        g, cfg, plan = self.grid, self.cfg, self.plan
        fl = self.full("final_ln")
        tied = self.specs.get("lm_head") is None
        hname = "embed" if tied else "lm_head"
        hdim = 0 if tied else 1
        split = self._split(hname, hdim)
        heads = self.tp(hname) if split else self.full(hname)
        logits, labels = [], []
        for w, (x, p) in enumerate(zip(xs, parts)):
            h = heads[w].T if tied else heads[w]
            n = h.shape[1]
            lo = self.mpos[w] * n if split else 0
            lg = (Lyr.rmsnorm(x, fl[w], cfg.norm_eps) @ h).float()
            lg = lg + vocab_mask(plan, lo, n, lg.device)
            if cfg.vision is not None and "patches" in p:
                lg = lg[:, p["patches"].shape[1]:]
            logits.append(lg)
            labels.append(p["tokens"][:, 1:].long() - lo)
        mx = [lg.detach().amax(-1) for lg in logits]
        if split:
            mx = g.all_reduce_max(mx, MODEL)
        se = [torch.exp(lg - m[..., None]).sum(-1)
              for lg, m in zip(logits, mx)]
        lab = []
        for lg, lb in zip(logits, labels):
            inr = (lb >= 0) & (lb < lg.shape[-1])
            pick = torch.gather(lg, -1, lb.clamp(0, lg.shape[-1] - 1)[..., None])
            lab.append(torch.where(inr, pick[..., 0], 0.0))
        if split:
            se = g.all_reduce_sum(se, MODEL)
            lab = g.all_reduce_sum(lab, MODEL)
        return [torch.log(s) + m - lb for s, m, lb in zip(se, mx, lab)]

    def loss(self, parts: List[Dict[str, torch.Tensor]]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(the total loss, {"ce", "aux"}) of the global batch, on worker
        0's device; ``parts``: each worker's rows (``split_batch``)."""
        g, cfg = self.grid, self.cfg
        xs = self._embed(parts)
        S = xs[0].shape[1]
        poss = [torch.arange(S, dtype=torch.int32, device=x.device)[None]
                .expand(x.shape[0], S) for x in xs]
        after = cross_after(cfg)
        mems = self._cross_memory(parts) if after else None
        dev0 = g.devices[0]
        aux = torch.zeros((), dtype=torch.float32, device=dev0)
        for li, kind in enumerate(cfg.pattern):
            fn = lambda *a, li=li, kind=kind: self._block(li, kind, poss, *a)
            xs, a = checkpoint(fn, *xs, use_reentrant=False)
            xs = list(xs)
            if a is not None:
                aux = aux + a.to(dev0)
            if li in after:
                gi = after[li]
                xs = [x + B.cross_attention(
                    mems[w][0][gi], x, cfg, self.plan, mems[w][1][0][gi],
                    mems[w][1][1][gi]) for w, x in enumerate(xs)]
        nll = self._head_loss(xs, parts)
        sums = [s.sum() if self.mpos[w] == 0 else None
                for w, s in enumerate(nll)]
        total = g.all_reduce_sum(sums, self.baxes)[0]
        count = nll[0].numel() * g.extent(self.baxes)
        ce = total / count
        return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}

    # -- the update -------------------------------------------------------------
    @torch.no_grad()
    def reduce_grads(self) -> Dict[str, List[torch.Tensor]]:
        """Each shard's gradient summed over the workers holding a copy
        of it (fp32, in position order, one copy a worker: bit-equal),
        a gradient of None counting as zero."""
        g, out = self.grid, {}
        for name, parts in self.shards.items():
            named = {a for e in self.specs[name] for a in spec_axes(e)}
            rep = tuple(a for a in g.axis_names if a not in named)
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in parts]
            if g.extent(rep) > 1:
                for grp in g.groups(rep):
                    total = grads[grp[0]].float()
                    for u in grp[1:]:
                        total = total + grads[u].to(total.device).float()
                    total = total.to(parts[0].dtype)
                    TALLY.add("all-reduce", 2 * (len(grp) - 1)
                              * total.numel() * total.element_size())
                    for u in grp:
                        grads[u] = total.to(g.devices[u], copy=True)
            out[name] = grads
        return out

    @torch.no_grad()
    def grad_norm(self, grads: Dict[str, List[torch.Tensor]]) -> torch.Tensor:
        """The global gradient norm, every logical element once (one
        owner a shard), on worker 0's device."""
        g = self.grid
        dev0 = g.devices[0]
        sq = [torch.sum(torch.square(parts[w].float())).to(dev0)
              for name, parts in grads.items()
              for w in SH.owners(self.specs[name], g)]
        TALLY.add("all-reduce", 2 * (g.W - 1) * 4)
        return torch.sqrt(torch.stack(sq).sum())

    def update(self, opt_update, state: AdamWState) -> AdamWState:
        """AdamW on every worker's shards, in place, from the gradients
        the backward left on them."""
        return self.apply(opt_update, state, self.reduce_grads())

    def apply(self, opt_update, state: AdamWState,
              grads: Dict[str, List[torch.Tensor]]) -> AdamWState:
        """AdamW on every worker's shards, in place, from ``grads`` (one
        tensor a worker, a shard's copies equal: ``reduce_grads``)."""
        gnorm = self.grad_norm(grads)
        new = state
        for w, dev in enumerate(self.grid.devices):
            new = opt_update({k: v[w] for k, v in grads.items()},
                             AdamWState(state.step,
                                        {k: v[w] for k, v in state.mu.items()},
                                        {k: v[w] for k, v in state.nu.items()}),
                             {k: v[w] for k, v in self.shards.items()},
                             gnorm=gnorm.to(dev))
        for parts in self.shards.values():
            for p in parts:
                p.grad = None
        return AdamWState(new.step, state.mu, state.nu)


def opt_init_sharded(shards: Shards) -> AdamWState:
    """AdamW's zero state for sharded weights: fp32 moments placed like
    them (one a worker)."""
    def zeros():
        return {k: [torch.zeros_like(p, dtype=torch.float32) for p in v]
                for k, v in shards.items()}
    return AdamWState(0, zeros(), zeros())


def make_sharded_train_step(step: ShardedStep, opt_update):
    """``train_step(opt_state, batch) -> (opt_state, metrics)`` over the
    grid, as ``make_train_step``'s: ``batch`` the global batch (split
    over the batch axes here), metrics detached scalars on worker 0's
    device."""
    def train_step(opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        loss, metrics = step.loss(split_batch(batch, step.grid))
        loss.backward()
        opt_state = step.update(opt_update, opt_state)
        return opt_state, {k: v.detach() for k, v in
                           dict(metrics, loss=loss).items()}
    return train_step


def analytic_bytes(step: ShardedStep, rows: int, seq: int
                   ) -> Dict[str, int]:
    """The bytes one train step of a model of ATTN blocks with dense MLPs
    moves between workers, by kind, from the placements and the shapes
    alone: each leaf gathered where it is used (a block's leaves in the
    forward and again in the recompute) and its gradient reduce-scattered
    once; a gated ``wi``'s re-lay and its reverse; two TP all-reduces of
    the activations a block in the forward, one in the recompute (the
    attention's: the recompute stops once the block's saved tensors are
    back, before the MLP's) and two in the backward; the embedding's
    all-reduce and its gradient's; the
    vocab-parallel cross-entropy's max, sum and label all-reduces (the
    last two with their gradients); the loss's sum over the batch axes
    and its gradient; each replicated shard's gradient summed over its
    copies; the gradient norm.  ``rows``: batch rows a batch shard."""
    g, cfg, plan = step.grid, step.cfg, step.plan
    if any(k != "attn" for k in cfg.pattern) or cfg.encoder is not None \
            or cfg.vision is not None:
        raise NotImplementedError("analytic_bytes: ATTN blocks only")
    W, M = g.W, step.M
    Dn = g.extent(step.baxes)
    elt = torch.empty((), dtype=B.dtype_of(cfg)).element_size()
    out = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
           "all-to-all": 0, "collective-permute": 0}
    other = tuple(a for a in g.axis_names if a != MODEL)
    tp_leaves = {"attn.wq", "attn.wo", "mlp.wo", "embed", "lm_head"}
    if plan.kv_replication == 1:
        tp_leaves |= {"attn.wk", "attn.wv"}
    gated = cfg.activation in ("swiglu", "geglu")

    def gathered(name: str, axes) -> int:
        b = step.shards[name][0].numel() * elt
        total = 0
        for entry in step.specs[name]:
            names = spec_axes(entry)
            if names and set(names) <= set(axes):
                n = g.extent(names)
                total += W * (n - 1) * b
                b *= n
        return total

    for name, parts in step.shards.items():
        short = name.split(".", 2)[-1] if name.startswith("layers.") \
            else name
        uses = 2 if name.startswith("layers.") else 1
        axes = g.axis_names
        if M > 1 and (short in tp_leaves or short == "mlp.wi"):
            axes = other
        b = gathered(name, axes)
        out["all-gather"] += uses * b
        out["reduce-scatter"] += b
        if M > 1 and short == "mlp.wi" and gated:
            piece = parts[0].numel() * elt // 2
            foreign = sum((i // 2 != i) + ((M + i) // 2 != i)
                          for i in range(M))
            out["all-to-all"] += (uses + 1) * (W // M) * foreign * piece
        named = {a for e in step.specs[name] for a in spec_axes(e)}
        n = g.extent(tuple(a for a in g.axis_names if a not in named))
        out["all-reduce"] += (W // n) * 2 * (n - 1) * parts[0].numel() * elt
    act = rows * seq * cfg.d_model * elt
    tok = rows * seq * 4
    if M > 1:
        per = (W // M) * 2 * (M - 1)
        out["all-reduce"] += per * act * 5 * cfg.num_layers
        out["all-reduce"] += per * act * 2                   # embedding
        out["all-reduce"] += per * tok * (1 + 2 * 2)         # max, se, lab
    out["all-reduce"] += 2 * 2 * (Dn - 1) * 4               # the loss
    out["all-reduce"] += 2 * (W - 1) * 4                    # the norm
    return out

