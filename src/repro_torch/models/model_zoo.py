"""Task-level model API: batches, loss and train step; prefill, serve
step, decode loops.

Port of ``repro.models.model_zoo`` for every family: dense, moe, ssm
(mamba2), hybrid (zamba2), vlm (internvl2) and enc_dec (seamless-m4t).
As in the reference, vlm and enc_dec have neither a bulk (chunked)
prefill nor a paged cache: a serving engine feeds their prompts token by
token through the dense cache's decode step, text only (an enc_dec lane's
cross cache stays zero, a vlm lane gets no patches); frames and patch
embeddings enter through ``make_prefill`` and ``lm_loss``.

Training keeps the reference's state: ``TrainState(step, params, opt)``
with ``params`` the reference's stacked tree in ``param_dtype`` (float32
masters, leaf for leaf and shape for shape the JAX tree, so m and v line
up with the reference's and a state can cross packages through
``state_from_numpy`` / ``state_to_numpy``).  The loss reads it through
``convert.compute_view``, made once per micro-batch.  Micro-batches
accumulate as the reference's scan does: ``backward`` per micro-batch
into the float32 ``.grad`` of the masters, in micro-batch order, then
the division by ``n_micro``, then the ``grad_reduce_dtype`` cast.

Serving: ``lax.scan`` over layers is a Python loop; the ``n_steps``
scan of the decode loop is a Python loop of device ops with no
``.item()``, no ``.cpu()``, no truth value of a tensor and no
boolean-mask indexing inside it, so a decode window never waits for the
host.

Caches are updated in place: a serve step, decode loop or prefill
mutates the state it is given and returns it.  The KV cache is bf16
whatever the compute dtype, as in the reference.  A paged pool holds one
sink row past its ``num_blocks`` live rows (see ``layers``).

Recurrent leaves, ``(L, B, ...)`` for ssm and ``(periods, attn_every,
B, ...)`` for hybrid: ``ssm`` (the SSD state) is float32, and ``conv``
(the last W-1 pre-conv activations) has the dtype the reference's decode
step carries, ``promote_types(bf16, compute dtype)`` (``conv_dtype``):
bf16 in bf16 compute, float32 in float32 compute.  The reference declares
the leaf bf16 and its prefills round the conv tail to bf16
(``repro/models/model_zoo.py:410, :430``), but a float32 step concatenates
that state with float32 activations and returns the float32 window as the
new state (``repro/models/mamba2.py:133-149``), so from the second step on
its chain carries float32.  The port's prefills (``make_prefill``, the
bulk and paged chunk prefills) round the tail to bf16 as the reference's
do and store it in the leaf; a step writes its new window unrounded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import dtype_of, resolve_device
from repro_torch.launch.sharding import (BATCH_AXES, ShardingRules,
                                         axis_sizes, batch_group,
                                         coordinate, gather_block,
                                         gather_parts, local_block,
                                         max_over_model, reduce_from_model,
                                         use_rules)
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as ssm_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as T
from repro_torch.models.convert import compute_view, params_from_numpy
from repro_torch.models.schema import (abstract_params, count_params,
                                       init_params)
from repro_torch.optim import adamw

# Families whose prefill needs only ``tokens`` (no frames / patch embeds)
# and can therefore be bulk-prefilled by a serving engine.
BULK_PREFILL_FAMILIES = ("dense", "moe", "ssm", "hybrid")
# Causal-attention families ignore a padded tail (position i never attends
# to j > i), so a prompt chunk may be right-padded to a bucket size.
# Recurrent families (ssm/hybrid) must never feed pad tokens through the
# state recurrence; their chunks are always fully real.
PAD_SAFE_FAMILIES = ("dense", "moe")
# Decoder-only families with attention in every layer (no recurrent
# leaves): every layer holds k/v, and the feed-forward half is a SwiGLU
# MLP (dense, vlm) or a MoE block (moe).
DECODER_FAMILIES = ("dense", "vlm", "moe")
# Families with a paged cache (the serving engine's paged admission path).
PAGED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _paged(cfg: ModelConfig):
    """``ValueError`` for a family without a paged cache (vlm, enc_dec),
    as the reference raises it."""
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(f"paged cache unsupported for {cfg.family}")


def paged_kv_keys(cfg: ModelConfig):
    """Cache keys stored in the block pool (vs. per-lane recurrent)."""
    _paged(cfg)
    return () if cfg.family == "ssm" else ("k", "v")


def _mamba_layers(params, cfg: ModelConfig):
    """The Mamba2 layers of one period (hybrid) or of the model (ssm):
    ``[(period or None, [(index, layer params), ...]), ...]``, where
    ``index`` addresses the recurrent leaves (``cache["ssm"][index]``)."""
    if cfg.family == "ssm":
        return [(None, [(i, lp) for i, lp in enumerate(params["layers"])])]
    return [(pi, [((pi, li), lp) for li, lp in enumerate(period)])
            for pi, period in enumerate(params["mamba"])]


def conv_dtype(cfg: ModelConfig) -> torch.dtype:
    """The recurrent ``conv`` leaf's dtype: the reference's decode step
    promotes its bf16 state with the compute dtype's activations
    (``repro/models/mamba2.py:133-149``), so bf16 in bf16 compute and
    float32 in float32 compute."""
    return torch.promote_types(torch.bfloat16, dtype_of(cfg.compute_dtype))


def _prefill_conv(conv, cfg: ModelConfig):
    """A prefill's conv tail as the leaf stores it: rounded to bf16, as
    the reference's prefills round it (``repro/models/model_zoo.py:410``),
    in ``conv_dtype``."""
    return conv.to(torch.bfloat16).to(conv_dtype(cfg))


def _recurrent_cache(cfg: ModelConfig, B: int, dev) -> Dict[str, torch.Tensor]:
    """Zeroed ``ssm`` (float32) and ``conv`` (``conv_dtype``) leaves for B
    lanes."""
    _, nheads, conv_dim, _ = ssm_lib.mamba2_dims(cfg)
    lead = ((cfg.num_layers,) if cfg.family == "ssm"
            else (cfg.num_layers // cfg.attn_every, cfg.attn_every))
    return {
        "ssm": torch.zeros(lead + (B, nheads, cfg.ssm_head_dim,
                                   cfg.ssm_state),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros(lead + (B, cfg.conv_width - 1, conv_dim),
                            dtype=conv_dtype(cfg), device=dev)}


def lane_axis(cfg: ModelConfig) -> int:
    """The lane (batch) axis of the recurrent leaves."""
    return 1 if cfg.family == "ssm" else 2


def _attn_layers(cfg: ModelConfig) -> int:
    """Leading extent of the k/v leaves: layers (dense, vlm, moe), decoder
    layers (enc_dec), periods (hybrid)."""
    if cfg.family in DECODER_FAMILIES:
        return cfg.num_layers
    if cfg.family == "enc_dec":
        return cfg.dec_layers
    return cfg.num_layers // cfg.attn_every


def init_serving_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                        mesh=None):
    """Random weights for ``cfg``, drawn on ``device`` from a seeded
    ``torch.Generator`` and laid out as ``convert`` lays them out.

    Leaves are drawn in float32 and stored in ``compute_dtype`` leaf by
    leaf (the values the reference's per-use cast of its float32 params
    would give), so a full-width model never holds a float32 copy; norms
    stay float32, as ``convert`` keeps them, and Mamba2's
    ``A_log``/``dt_bias`` and the MoE ``router`` are drawn and kept in
    float32 (their schemas say so).  ``mesh``: this rank's blocks of the
    same draw (``serving_params``)."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    tree = init_params(T.model_schema(cfg), gen, dev, cfg.compute_dtype)
    return serving_params(tree, cfg, mesh, dev)


def serving_params(tree, cfg: ModelConfig, mesh=None, device="cuda"):
    """A whole parameter tree in the reference's stacked layout (numpy,
    or tensors as ``init_params`` draws them) -> the params that
    ``make_prefill`` and ``make_serve_step`` read (``convert``'s layout)
    on ``device`` (None: where they are).  ``mesh``: this rank's blocks
    (``mesh_blocks``), each a copy of its own."""
    if mesh is not None:
        whole = adamw.tree_map(torch.as_tensor, tree)
        tree = adamw.tree_map(
            lambda t, b: b if b is t else b.clone(
                memory_format=torch.contiguous_format),
            whole, mesh_blocks(whole, cfg, mesh))
    return params_from_numpy(tree, cfg,
                             None if device is None else resolve_device(
                                 device))


def mesh_blocks(tree, cfg: ModelConfig, mesh):
    """This rank's blocks of a whole stacked parameter tree over a
    ``("data", "model")`` or ``("pod", "data", "model")`` mesh (the same
    on every pod and data rank): each leaf's ``local_block`` of its
    ``param_shardings`` (the reference's ``in_shardings`` for a cell),
    except the Mamba2 leaves over a model axis above 1.  Where the rules
    shard ``ssm_heads`` over it, the leaves of ``mamba2.HEAD_LEAVES`` are
    cut to the rank's heads (``mamba2.head_leaves``: the reference's
    specs cut the packed ``in_proj`` and ``conv_w`` in blocks that do not
    follow their parts) and ``out_proj`` keeps its block (the heads'
    channels); where they replicate ``ssm_heads``, every Mamba2 leaf is
    whole.  Views where a leaf is cut, new tensors for the head cut."""
    from repro_torch.launch.sharding import param_shardings
    rules, coord = ShardingRules(mesh), coordinate(mesh)
    blocks = adamw.tree_map(lambda t, s: local_block(t, s, coord), tree,
                            param_shardings(rules, T.model_schema(cfg)))
    key = {"ssm": "layers", "hybrid": "mamba"}.get(cfg.family)
    m = axis_sizes(mesh).get("model", 1)
    if key is not None and m > 1:
        blocks[key] = (dict(blocks[key], **ssm_lib.head_leaves(
            tree[key], cfg, coord["model"], m)) if _heads_split(cfg, rules)
            else dict(tree[key]))
    return blocks


def _heads_split(cfg: ModelConfig, rules) -> bool:
    """Whether ``rules`` shard the SSM heads over a model axis above 1."""
    return (axis_sizes(rules.mesh).get("model", 1) > 1 and
            rules.mesh_axes_for("ssm_heads", cfg.ssm_heads) == "model")


def abstract_serving_params(cfg: ModelConfig, mesh=None):
    """``init_serving_params``' leaves as meta tensors (shape and dtype,
    no storage): the layout ``make_prefill`` and ``make_serve_step``
    read, from the same schema and ``convert`` rules (``mesh``: this
    rank's blocks)."""
    tree = abstract_params(T.model_schema(cfg), cfg.compute_dtype)
    return serving_params(tree, cfg, mesh, device=None)


def num_params(cfg: ModelConfig) -> int:
    return count_params(T.model_schema(cfg))


def active_params(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: routed top_k of num_experts)."""
    total = num_params(cfg)
    if cfg.family != "moe":
        return total
    per_expert = 3 * cfg.d_model * cfg.d_ff
    routed = cfg.num_layers * cfg.num_experts * per_expert
    active = cfg.num_layers * cfg.top_k * per_expert
    return total - routed + active


def _feed_forward(lp, h, cfg: ModelConfig):
    """A decoder layer's second half: the MoE block (its aux loss is
    dropped, as serving drops it) or the SwiGLU MLP."""
    if cfg.family == "moe":
        return moe_lib.moe_block(lp["moe"], h, cfg)[0]
    return L.swiglu_block(lp["mlp"], h, cfg)


# ============================================================== batches
class ArraySpec(NamedTuple):
    """One input of a batch: its shape and torch dtype.

    The dtype is a ``torch.dtype`` (``torch.int32`` or ``torch.bfloat16``),
    where the reference's ``ShapeDtypeStruct`` holds a numpy one: numpy
    has no bf16 without ``ml_dtypes``.  ``torch.bfloat16`` stands for the
    reference's ``jnp.bfloat16``, ``torch.int32`` for ``int32``."""
    shape: tuple
    dtype: torch.dtype


def batch_spec(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, ArraySpec]:
    """The input batch of a (arch x shape) cell, as the reference's
    ``batch_spec`` gives it: ``(shape, dtype)`` pairs.  Tokens and labels
    are int32; an enc_dec model's ``frames`` (B, S, d) and a vlm model's
    ``patch_embeds`` (B, frontend_seq, d) are bf16, and a vlm model's
    tokens fill the S - frontend_seq positions after the patches."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        st = S - cfg.frontend_seq if cfg.family == "vlm" else S
        out = {"tokens": ArraySpec((B, st), i32)}
        if shape.kind == "train":
            out["labels"] = ArraySpec((B, st), i32)
        if cfg.family == "enc_dec":
            out["frames"] = ArraySpec((B, S, cfg.d_model), bf16)
        elif cfg.family == "vlm":
            out["patch_embeds"] = ArraySpec(
                (B, cfg.frontend_seq, cfg.d_model), bf16)
        return out
    if shape.kind == "decode":
        return {"tokens": ArraySpec((B, 1), i32),
                "active": ArraySpec((B,), i32)}
    raise ValueError(shape.kind)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
               device="cuda") -> Dict[str, torch.Tensor]:
    """A random batch matching ``batch_spec`` (smoke tests): tokens and
    labels uniform over the vocabulary and bf16 leaves (frames, patch
    embeddings) standard normal, from a seeded CPU generator; ``active``
    all ones."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in batch_spec(cfg, shape).items():
        if k == "active":
            t = torch.ones(v.shape, dtype=torch.int32)
        elif v.dtype == torch.int32:
            t = torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                              dtype=torch.int32)
        else:
            t = torch.randn(v.shape, generator=gen).to(v.dtype)
        out[k] = t.to(dev)
    return out


# ============================================================== loss
def lm_loss(params, batch, cfg: ModelConfig, *, impl: str = "kernel"):
    """Causal-LM cross-entropy (mean over tokens) + MoE aux loss.

    ``params``: a ``TrainState``'s tree (stacked, float32 masters), read
    through ``convert.compute_view``.  enc_dec runs ``enc_dec_forward``
    over the batch's ``frames``; vlm puts ``patch_embeds`` in front of
    the tokens and takes the loss on the text positions only.  Returns
    ``(loss, {"nll", "aux"})``, float32 scalars."""
    view = compute_view(params, cfg)
    if cfg.family == "enc_dec":
        h = T.enc_dec_forward(view, batch["frames"], batch["tokens"], cfg,
                              impl=impl)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    else:
        h, aux = T.decoder_forward(view, batch["tokens"], cfg,
                                   patch_embeds=batch.get("patch_embeds"),
                                   impl=impl)
        h = h[:, cfg.frontend_seq:] if cfg.family == "vlm" else h
    logits = T.lm_logits(view, h, cfg)        # (B, S, V) float32
    if T.vocab_block(cfg) is None:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1,
                            batch["labels"].long()[..., None])[..., 0]
    else:
        nll = _vocab_parallel_nll(logits, batch["labels"], cfg)
    loss = nll.mean() + aux
    return loss, {"nll": nll.mean(), "aux": aux}


def _vocab_parallel_nll(logits, labels, cfg: ModelConfig):
    """The cross entropy of logits sharded by vocabulary blocks over the
    model axis (this rank's block ``logits``, float32): the maximum, the
    sum of exps and the target logit are reduced over the model group,
    so no rank holds the whole vocabulary.  ``log(sum exp(l - max)) -
    (l_target - max)``, the reference's ``log_softmax`` and gather."""
    lo, size = T.vocab_block(cfg)
    shift = max_over_model(logits.amax(dim=-1, keepdim=True))
    shifted = logits - shift
    sumexp = reduce_from_model(torch.exp(shifted).sum(dim=-1))
    ids = labels.long() - lo
    inside = (ids >= 0) & (ids < size)
    target = shifted.gather(-1, ids.clamp(0, size - 1)[..., None])[..., 0]
    target = reduce_from_model(torch.where(inside, target,
                                           target.new_zeros(())))
    return torch.log(sumexp) - target


# ============================================================== train state
class TrainState(NamedTuple):
    step: torch.Tensor          # () int32
    params: Any                 # the reference's stacked tree, float32
    opt: adamw.AdamWState


def init_state(cfg: ModelConfig, seed: int = 0,
               device="cuda") -> TrainState:
    """Random float32 masters for ``cfg`` (``schema.init_params`` from a
    seeded generator on ``device``; its values are not JAX's, see
    ``state_from_numpy``), zero moments, step 0."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    params = init_params(T.model_schema(cfg), gen, dev, cfg.param_dtype)
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                      params, adamw.init(params))


def abstract_state(cfg: ModelConfig) -> TrainState:
    """``init_state``'s leaves as meta tensors (shape and dtype, no
    storage), the reference's ``abstract_state``."""
    params = abstract_params(T.model_schema(cfg), cfg.param_dtype)
    return TrainState(torch.empty((), dtype=torch.int32, device="meta"),
                      params, adamw.init(params))


def state_from_numpy(state, device="cuda") -> TrainState:
    """A JAX ``TrainState`` handed over as numpy (``jax.tree.map(
    np.asarray, state)``; any object with ``step``, ``params`` and
    ``opt.m`` / ``opt.v``) -> the port's, leaf for leaf on ``device``."""
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x)).to(dev)
    return TrainState(t(state.step), adamw.tree_map(t, state.params),
                      adamw.AdamWState(adamw.tree_map(t, state.opt.m),
                                       adamw.tree_map(t, state.opt.v)))


def state_to_numpy(state: TrainState) -> TrainState:
    """The port's state -> the same tree of numpy arrays (host copies);
    ``repro.models.model_zoo.TrainState(step, params, AdamWState(m, v))``
    of them (as ``jnp`` arrays) is the reference's state."""
    def n(x):
        return x.detach().cpu().numpy()
    return TrainState(n(state.step), adamw.tree_map(n, state.params),
                      adamw.AdamWState(adamw.tree_map(n, state.opt.m),
                                       adamw.tree_map(n, state.opt.v)))


# ============================================================== train step
def train_grads(params, batch, cfg: ModelConfig, impl: str = "kernel",
                dp: Optional["DataParallel"] = None):
    """The gradient half of a train step: ``(grads, loss, nll, aux)``.

    The batch splits into ``cfg.num_microbatches`` consecutive row
    blocks; each block's loss is back-propagated into the float32
    ``.grad`` of detached copies of the masters (``params`` is left as
    it is), in block order, as the reference's scan adds them; then the
    sum is divided by ``n_micro`` and, with ``grad_reduce_dtype ==
    "bfloat16"``, cast to bf16.  ``loss`` is the summed loss over
    ``n_micro``; ``nll`` and ``aux`` the means of the blocks' values.

    With ``dp`` (a ``DataParallel`` layout) the rank takes its pieces of
    the global batch's micro-batches (``dp.micro_blocks``) and runs the
    model under the sharding rules they come with: over a model axis above
    1 the blocks are tensor parallel on this rank's blocks of the
    parameters (``params`` holds them), and the gradient of each leaf is
    this rank's block of the whole gradient.  The gradient is summed
    over the batch ranks (pod x data) and divided by the pieces of all of
    them (every
    micro-batch is run by as many): the gradient of the reference's
    global token mean.  Over a model
    axis, the Mamba2 leaves that a rank reads whole or in part
    (``DataParallel.compute_leaves``) have their partial gradients
    summed over the model group first (``DataParallel.model_grads``).
    ``grad_schedule == "overlapped"`` reduce-scatters each block's
    gradient as it is made (``_scatter_grads``), in float32; ``"fused"``
    reduces once, after the ``grad_reduce_dtype`` cast.  The gradient
    comes back in the layout the update takes: with ``cfg.zero1`` each
    leaf's ZeRO-1 block, else the rank's block of the whole leaf.  The
    metrics are the global ones (means over the batch ranks)."""
    leaves, rebuild = adamw.flatten(params)
    masters = [p.detach().requires_grad_() for p in leaves]
    # the leaves the model reads: the masters, or (Mamba2 over a model
    # axis) some of them gathered whole, once a step
    compute = masters if dp is None else dp.compute_leaves(masters)
    tree = rebuild(compute)
    if dp is None:
        n_micro, size = max(cfg.num_microbatches, 1), 1
        b = batch["tokens"].shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} is not a multiple of {n_micro} "
                             f"micro-batches")
        bm = b // n_micro
        blocks = [{k: v[i * bm:(i + 1) * bm] for k, v in batch.items()}
                  for i in range(n_micro)]
    else:
        (blocks, rules), size = dp.micro_blocks(batch), dp.batch.size
        n_micro = len(blocks)
    per_micro = dp is not None and cfg.grad_schedule == "overlapped"
    lsum = torch.zeros((), dtype=torch.float32,
                       device=batch["tokens"].device)
    nlls, auxs, acc = [], [], None
    with torch.enable_grad(), use_rules(None if dp is None else rules):
        for mb in blocks:
            loss, metrics = lm_loss(tree, mb, cfg, impl=impl)
            loss.backward()
            lsum = lsum + loss.detach()
            nlls.append(metrics["nll"].detach())
            auxs.append(metrics["aux"].detach())
            if per_micro:
                g = _scatter_grads(dp.model_grads(
                    [p.grad for p in compute]), dp)
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                for p in compute:
                    p.grad = None
    if per_micro:
        grads = acc
    else:
        grads = [p.grad for p in compute]
        grads = grads if dp is None else dp.model_grads(grads)
    grads = [g / (n_micro * size) for g in grads]
    if cfg.grad_reduce_dtype == "bfloat16":
        grads = [g.to(torch.bfloat16) for g in grads]
    out = (lsum / n_micro, torch.stack(nlls).mean(), torch.stack(auxs).mean())
    if dp is not None:
        if not per_micro:
            grads = [dp.reduce(g, i, scatter=dp.zero1)
                     for i, g in enumerate(grads)]
        elif not dp.zero1:
            grads = [dp.gather(g, i) for i, g in enumerate(grads)]
        out = tuple(dp.mean(torch.stack(out)).unbind(0))
    return (rebuild(grads),) + out


def make_train_step(cfg: ModelConfig, hp: Optional[adamw.HParams] = None,
                    impl: str = "kernel", mesh=None):
    """``fn(state, batch) -> (new_state, metrics)``: ``train_grads``, then
    one AdamW update.  ``metrics``: ``loss``, ``nll``, ``aux`` and
    ``grad_norm`` (of the gradient the update gets), 0-d float32
    tensors on the state's device.  ``impl`` goes to ``mamba2_block``
    only (``"ref"``: the plain SSD route on the card).

    ``mesh``: a ``DeviceMesh`` (``launch.mesh``) this rank belongs to;
    the step is then data parallel over its ``pod`` and ``data`` axes
    (``DataParallel``), takes the global batch and a state laid out by
    ``DataParallel.place``, and every rank of the mesh must call it.
    With ``cfg.zero1`` the update runs on each leaf's ZeRO-1 block (m
    and v are those blocks) and the new parameters are all-gathered over
    the data ranks.  Over a ``model`` axis above 1 the state holds this
    rank's blocks of the model-sharded leaves (``DataParallel.place``)
    and the step is tensor parallel over them."""
    hp = hp or adamw.HParams()
    dp = None if mesh is None else DataParallel(cfg, mesh)

    def train_step(state: TrainState, batch):
        grads, loss, nll, aux = train_grads(state.params, batch, cfg, impl,
                                            dp)
        if dp is not None and dp.zero1:
            gnorm = dp.norm(grads)
            blocks, opt = adamw.update(dp.blocks(state.params), grads,
                                       state.opt, state.step, hp, gnorm)
            params = dp.gather_tree(blocks)
        else:
            gnorm = (adamw.global_norm(grads) if dp is None
                     or dp.model_size == 1 else dp.norm(grads))
            params, opt = adamw.update(state.params, grads, state.opt,
                                       state.step, hp, gnorm)
        metrics = {"loss": loss, "nll": nll, "aux": aux, "grad_norm": gnorm}
        return TrainState(state.step + 1, params, opt), metrics

    return train_step


def _scatter_grads(grads, dp: Optional["DataParallel"]):
    """The reference constrains the gradient to the ZeRO-1 shardings under
    an active mesh (``model_zoo.py:229-241``), so GSPMD lowers its
    reduction as a reduce-scatter, and returns it as it is without one.
    The port, given a ``DataParallel`` layout: each leaf summed over the
    batch ranks into its ZeRO-1 block, a reduce-scatter over the data
    ranks along the dimension ``zero1_extend`` picks, then an all-reduce
    over the pod ranks (a leaf it leaves whole: an all-reduce over the
    batch group); without one (a single device), the identity."""
    if dp is None:
        return grads
    return [dp.reduce(g, i, scatter=True) for i, g in enumerate(grads)]


# ============================================================== data parallelism
# Mamba2 leaves that a tensor-parallel block reads whole (the reference
# cuts their packed dimension in blocks that do not follow its parts),
# and replicated ones that it reads in part (its heads' and channels')
MAMBA_WHOLE = ("in_proj", "conv_w")
MAMBA_PARTIAL = ("conv_b", "A_log", "D", "dt_bias", "ssm_norm")


def _key_paths(tree, prefix=()):
    """A tree of nested dicts -> the same tree with each leaf's key path."""
    return {k: _key_paths(v, prefix + (k,)) if isinstance(v, dict)
            else prefix + (k,) for k, v in tree.items()}


def _data_dim(spec) -> Optional[int]:
    """The dimension of a spec whose entry names the ``data`` axis (alone
    or after ``model``), or ``None``."""
    for dim, entry in enumerate(spec):
        if entry == "data" or (isinstance(entry, tuple) and "data" in entry):
            return dim
    return None


class DataParallel:
    """A train state's layout over a ``("data", "model")`` or ``("pod",
    "data", "model")`` ``DeviceMesh`` (``launch.mesh``) and the
    collectives of a step over it.

    The layout is the reference's (``launch.specs.state_shardings``,
    ``batch_shardings``), over two groups of ranks: the batch group
    (``launch.sharding.batch_group``: the pod x data ranks, flattened
    pod-major, as the rules' ``("pod", "data")`` entry orders them), and
    the ZeRO-1 group, ``data`` alone (``zero1_extend`` never scatters
    over ``pod``):

    * each micro-batch of the global batch splits by rows over the batch
      group (``micro_blocks``), as the reference's sharded micro-batches
      do, or, where it does not split over them, whole micro-batches or
      blocks of them go to the ranks in lockstep (``micro_blocks``);
    * each model rank holds its block of every leaf that the rules shard
      over ``model`` (``launch.sharding.local_block`` of its param
      sharding: ``model_dims[i]``, ``None`` for a replicated leaf), and
      the model's blocks are tensor parallel over them (every family:
      the encoder's blocks and cross attention of enc_dec too; an
      enc_dec model's frames and a vlm model's patch embeddings are
      batch leaves, split by rows over ``data`` and replicated over
      ``model``, as the reference's ``batch_shardings`` and its
      constraints keep them);
    * a tensor-parallel Mamba2 block reads ``in_proj`` and ``conv_w``
      whole: ``compute_leaves`` all-gathers each over the model group
      once a step (the stored blocks stay the reference's) and
      ``model_grads`` reduce-scatters its gradient back to the rank's
      block; the replicated ``conv_b``, ``A_log``, ``D``, ``dt_bias``
      and ``ssm_norm``, which each rank reads in part, have their
      gradients all-reduced over the model group;
    * with ``cfg.zero1``, m and v are the ZeRO-1 shardings' blocks: the
      rank's model block of leaf ``i`` split in ``size`` along
      ``dims[i]`` (the dimension of the ``data`` entry of its ZeRO-1
      spec, which may share it with ``model``, model major), data rank
      ``r`` keeping block ``r`` on every pod; a leaf with no such
      dimension (``None``) stays whole over the data ranks.

    Parameters, gradients and activations are plain tensors on each rank
    (never a DTensor: the kernels take plain tensors).  Gradients are
    summed over the batch group (with ZeRO-1 a reduce-scatter over
    ``data``, then an all-reduce of the block over ``pod``), and over the
    model group only where a
    rank reads a leaf whole or in part (the Mamba2 leaves above): each
    model rank's is otherwise already its block of the whole one, and a
    replicated leaf's is the same on every model rank (a replicated leaf
    stays bit-identical across them).

    The moe family's aux loss is a product of batch statistics and its
    capacity couples a token to its group (``repro/models/moe.py:66``):
    a moe block routes the rank's block of a micro-batch as the
    reference routes the whole one, from the routing pool that
    ``micro_blocks`` sets in the rules (the batch ranks that hold the
    micro-batch, pods included): the router statistics are summed over
    the pool, and where a routing group spans ranks the capacity
    positions come from the pool's count tables (``moe.capacity_positions``); with explicit
    expert parallelism each rank's aux is averaged as the reference's
    is (``moe._moe_explicit_ep``).  Over a model axis the expert
    weights are blocks like any other leaf: split by experts, by each
    expert's ``expert_ff``, or replicated, as the rules give them."""

    def __init__(self, cfg: ModelConfig, mesh):
        from repro_torch.launch.sharding import (axis_names, model_dim,
                                                 param_shardings,
                                                 zero1_shardings)
        names, sizes = axis_names(mesh), axis_sizes(mesh)
        if "data" not in names or set(names) - {"pod", "data", "model"}:
            raise ValueError(
                f"a {sizes} mesh: the port trains over ('data', 'model') "
                f"and ('pod', 'data', 'model') meshes")
        self.size, self.model_size = sizes["data"], sizes.get("model", 1)
        self.cfg, self.mesh, self.zero1 = cfg, mesh, cfg.zero1
        self.rules = ShardingRules(mesh)
        # the ZeRO-1 group (data) and the batch group (pod x data)
        self.group = mesh.get_group("data")
        self.rank = mesh.get_local_rank("data")
        self.batch = batch_group(mesh)
        self.batch_pg = self.batch.group if self.batch.size > 1 else \
            self.group
        self.pod_group = (mesh.get_group("pod") if sizes.get("pod", 1) > 1
                          else None)
        if self.model_size > 1:
            self.model_group = mesh.get_group("model")
            self.model_rank = mesh.get_local_rank("model")
        else:
            self.model_group, self.model_rank = None, 0
        self.coord = coordinate(mesh)
        schema = T.model_schema(cfg)
        self.shardings = adamw.flatten(param_shardings(self.rules,
                                                       schema))[0]
        self.model_dims = [model_dim(s) if self.model_size > 1 else None
                           for s in self.shardings]
        self.dims = [_data_dim(s.spec) for s in adamw.flatten(
            zero1_shardings(self.rules, schema))[0]]
        # Mamba2 leaves read whole (``whole``) or in part (``partial``)
        self.whole, self.partial = [], []
        if self.model_size > 1 and cfg.family in ("ssm", "hybrid"):
            from repro_torch.models.mamba2 import head_block
            head_block(cfg, self.model_size, self.model_rank)  # divides?
            paths = adamw.flatten(_key_paths(schema))[0]
            for i, path in enumerate(paths):
                if path[0] not in ("layers", "mamba"):
                    continue
                if path[-1] in MAMBA_WHOLE:
                    (self.whole if self.model_dims[i] is not None
                     else self.partial).append(i)
                elif path[-1] in MAMBA_PARTIAL:
                    self.partial.append(i)

    # ------------------------------------------------------------ batches
    def micro_blocks(self, batch):
        """This rank's pieces of the global batch, in the order it runs
        them, and the sharding rules to run them under: ``(blocks,
        rules)``.

        The batch splits into ``cfg.num_microbatches`` consecutive row
        blocks, as the reference's ``reshape_micro`` splits it (a batch
        they do not divide raises ``ValueError``, where the reference's
        ``assert`` fails).  The batch ranks (``self.batch``: pod x data,
        pod-major) step through their pieces in lockstep, every piece as
        many rows, and the ranks that hold the pieces of one micro-batch
        at a step are its routing pool (``launch.sharding.routing_pool``,
        set in ``rules``):

        * a micro-batch that splits over the batch ranks: each in turn,
          batch rank ``r`` taking block ``r`` of it, the rows the
          reference's sharded micro-batch gives it (the pool: every
          batch rank);
        * else, where a rank's share of the batch (the rows the
          reference's batch sharding gives it) holds whole micro-batches,
          the rank runs them in turn, each whole (its pool: the rank
          alone);
        * else, with ``u`` the largest number of rows that divides both
          a micro-batch and a rank's share of the batch: at each step
          the ranks take the next ``size * u`` rows, ``u`` a rank, in
          rank order, and each micro-batch is held by ``micro / u``
          consecutive ranks (2-row micro-batches over 4 ranks: 2, each
          rank its share in one piece);
        * where the rules replicate the batch (its rows do not divide
          over the batch ranks: the reference replicates them over pod
          and data alike), every rank runs every micro-batch whole.

        Every micro-batch is run by as many pieces, so the gradient
        summed over the ranks' pieces and divided by their number
        (``train_grads``) is the reference's."""
        B = batch["tokens"].shape[0]
        n = max(self.cfg.num_microbatches, 1)
        if B % n:
            raise ValueError(
                f"{self.cfg.name}: a batch of {B} rows does not split into "
                f"{n} micro-batches")
        bm, size, r = B // n, self.batch.size, self.batch.rank
        if bm % size == 0:
            u = bm // size
            starts, pool = [i * bm + r * u for i in range(n)], (0, size)
        elif B % size == 0:
            share = B // size
            u = math.gcd(bm, share)
            a = bm // u
            starts = ([r * share + t * u for t in range(share // u)] if a == 1
                      else [t * size * u + r * u for t in range(share // u)])
            pool = (r - r % a, a)
        else:
            u, starts, pool = bm, [i * bm for i in range(n)], (r, 1)
        blocks = [{k: v[s:s + u] for k, v in batch.items()} for s in starts]
        return blocks, self.rules.with_pool(*pool)

    # ------------------------------------------------------------ leaves
    def _block(self, t, i):
        d = self.dims[i]
        return t if d is None else t.chunk(self.size, d)[self.rank]

    def reduce(self, g, i, scatter: bool):
        """Leaf ``i``'s ``g`` (this rank's model block) summed over the
        batch ranks: with ``scatter`` its ZeRO-1 block (a reduce-scatter
        over the data ranks, then, over a pod axis above 1, an all-reduce
        of the block over the pod ranks, counted in
        ``launch.sharding.all_reduces``), else whole (an all-reduce over
        the batch group)."""
        from repro_torch.launch.sharding import all_reduce
        d = self.dims[i] if scatter else None
        if d is None:
            dist.all_reduce(g, group=self.batch_pg)
            return g
        parts = [c.contiguous() for c in g.chunk(self.size, d)]
        out = torch.empty_like(parts[self.rank])
        dist.reduce_scatter(out, parts, group=self.group)
        return out if self.pod_group is None else all_reduce(
            out, self.pod_group)

    def gather(self, t, i):
        """Leaf ``i``'s model block from its ZeRO-1 blocks (an all-gather
        over the data ranks)."""
        d = self.dims[i]
        if d is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, d)

    def blocks(self, tree):
        leaves, rebuild = adamw.flatten(tree)
        return rebuild([self._block(t, i) for i, t in enumerate(leaves)])

    def gather_tree(self, tree):
        leaves, rebuild = adamw.flatten(tree)
        return rebuild([self.gather(t, i) for i, t in enumerate(leaves)])

    def model_blocks(self, tree):
        """Whole leaves -> this rank's model blocks (``local_block``: the
        param specs split over ``model`` only)."""
        if self.model_size == 1:
            return tree
        leaves, rebuild = adamw.flatten(tree)
        return rebuild([local_block(t, s, self.coord)
                        for t, s in zip(leaves, self.shardings)])

    def gather_model(self, tree):
        """``model_blocks``' inverse: whole leaves (an all-gather over the
        model ranks for each sharded leaf, not counted in
        ``launch.sharding.all_gathers``)."""
        if self.model_size == 1:
            return tree
        leaves, rebuild = adamw.flatten(tree)
        return rebuild([gather_block(t, s, count=False)
                        for t, s in zip(leaves, self.shardings)])

    def compute_leaves(self, masters):
        """The leaves the model reads from the rank's ``masters``: each
        leaf of ``whole`` all-gathered over the model group into a new
        leaf that takes the gradient (once a step), the others as they
        are."""
        out = list(masters)
        for i in self.whole:
            out[i] = gather_block(masters[i].detach(), self.shardings[i],
                                  count=False).requires_grad_()
        return out

    def model_grads(self, grads):
        """``compute_leaves``' gradients -> the rank's: a leaf of
        ``whole`` reduce-scattered over the model group to the rank's
        block, a leaf of ``partial`` all-reduced over it; the others as
        they are."""
        from repro_torch.launch.sharding import all_reduce
        out = list(grads)
        for i in self.whole:
            d = self.model_dims[i]
            parts = [c.contiguous() for c in grads[i].chunk(
                self.model_size, d)]
            out[i] = torch.empty_like(parts[self.model_rank])
            dist.reduce_scatter(out[i], parts, group=self.model_group)
        for i in self.partial:
            out[i] = all_reduce(grads[i], self.model_group)
        return out

    def norm(self, grads) -> torch.Tensor:
        """The global norm of a gradient given as this rank's blocks: each
        leaf's squares summed over the data ranks where ZeRO-1 splits it
        (not over pod: a pod holds the same blocks) and over the model
        ranks where the rules shard it; a leaf whole over an axis counts
        once."""
        leaves = adamw.flatten(grads)[0]
        zero1 = self.zero1
        total = None
        for over_data in (False, True):
            for over_model in (False, True):
                parts = [torch.sum(torch.square(g.float()))
                         for g, d, md in zip(leaves, self.dims,
                                             self.model_dims)
                         if (zero1 and d is not None) == over_data
                         and (md is not None) == over_model]
                if not parts:
                    continue
                sq = sum(parts)
                if over_data:
                    dist.all_reduce(sq, group=self.group)
                if over_model:
                    dist.all_reduce(sq, group=self.model_group)
                total = sq if total is None else total + sq
        return torch.sqrt(total)

    def mean(self, t):
        """``t``'s mean over the batch ranks."""
        dist.all_reduce(t, group=self.batch_pg)
        return t / self.batch.size

    # ------------------------------------------------------------ state
    def place(self, state: TrainState) -> TrainState:
        """A whole state (every rank holds the same) -> this rank's: the
        model-sharded leaves cut to their model blocks, then, with
        ``cfg.zero1``, m and v to their ZeRO-1 blocks.  Each cut leaf is
        a copy of its own, not a view: the whole state is freed once the
        caller drops it."""
        def own(tree, cut):
            whole, rebuild = adamw.flatten(tree)
            return rebuild([t if c is t else c.clone(
                memory_format=torch.contiguous_format)
                for t, c in zip(whole, adamw.flatten(cut)[0])])
        m, v = self.model_blocks(state.opt.m), self.model_blocks(state.opt.v)
        if self.zero1:
            m, v = self.blocks(m), self.blocks(v)
        return TrainState(state.step,
                          own(state.params, self.model_blocks(state.params)),
                          adamw.AdamWState(own(state.opt.m, m),
                                           own(state.opt.v, v)))

    def gather_state(self, state: TrainState) -> TrainState:
        """``place``'s inverse: the whole state, on every rank."""
        m, v = state.opt.m, state.opt.v
        if self.zero1:
            m, v = self.gather_tree(m), self.gather_tree(v)
        return TrainState(state.step, self.gather_model(state.params),
                          adamw.AdamWState(self.gather_model(m),
                                           self.gather_model(v)))


# ============================================================== serving
@dataclasses.dataclass
class DecodeState:
    """Dense decode state.  cache: {"k", "v"} of (L, B, S, KV, D) bf16
    (dense, vlm, moe); {"ssm", "conv"} (ssm); both, k/v per period
    (hybrid); {"k", "v", "xk", "xv"} of (dec_layers, B, S, KV, D) bf16
    (enc_dec: self attention's cache and cross attention's k/v of the
    encoder output)."""
    cache: Dict[str, torch.Tensor]
    cache_len: torch.Tensor  # (B,) int32 filled positions


def init_decode_state(cfg: ModelConfig, shape: ShapeConfig,
                      fill_len: Optional[int] = None,
                      device="cuda") -> DecodeState:
    """A zeroed decode state, ``cache_len`` at ``fill_len`` (default
    ``seq_len - 1``)."""
    return _decode_state(cfg, shape, fill_len, resolve_device(device))


def abstract_decode_state(cfg: ModelConfig, shape: ShapeConfig,
                          mesh=None) -> DecodeState:
    """``init_decode_state``'s leaves as meta tensors (shape and dtype, no
    storage), the reference's ``abstract_decode_state``; ``mesh``: this
    rank's blocks."""
    state = _decode_state(cfg, shape, None, torch.device("meta"))
    return state if mesh is None else ServingMesh(
        cfg, shape, mesh).place_state(state)


def decode_state_logical_axes(cfg: ModelConfig) -> DecodeState:
    """Logical axes of the decode state's leaves (for shardings)."""
    kv4 = (None, "cache_batch", "cache_seq", "kv_heads", None)
    if cfg.family in DECODER_FAMILIES:
        cache = {"k": kv4, "v": kv4}
    elif cfg.family == "enc_dec":
        cache = {"k": kv4, "v": kv4, "xk": kv4, "xv": kv4}
    elif cfg.family == "ssm":
        cache = {"ssm": (None, "cache_batch", "ssm_heads", None, None),
                 "conv": (None, "cache_batch", None, "conv_dim")}
    elif cfg.family == "hybrid":
        cache = {"ssm": (None, None, "cache_batch", "ssm_heads", None, None),
                 "conv": (None, None, "cache_batch", None, "conv_dim"),
                 "k": kv4, "v": kv4}
    else:
        raise ValueError(cfg.family)
    return DecodeState(cache, ("cache_batch",))


def decode_state_shardings(cfg: ModelConfig, shape: ShapeConfig,
                           rules) -> DecodeState:
    """Each decode-state leaf's ``NamedSharding`` under ``rules``, the
    reference's ``launch.specs.decode_state_shardings``: ``cache_batch``
    over ``data`` where it divides, ``cache_seq`` over ``model``, so
    ``kv_heads`` (after it) stays replicated in the cache."""
    ab = _decode_state(cfg, shape, None, torch.device("meta"))
    ax = decode_state_logical_axes(cfg)
    return DecodeState(
        {k: rules.sharding(ax.cache[k], v.shape) for k, v in ab.cache.items()},
        rules.sharding(ax.cache_len, (shape.global_batch,)))


class ServingMesh:
    """A prefill's or a serve step's layout over a ``("data", "model")``
    or ``("pod", "data", "model")`` ``DeviceMesh`` (``launch.mesh``), the
    reference's ``input_specs`` and ``out_shardings`` for a prefill or
    decode cell:

    * the parameters: each rank's blocks (``serving_params``,
      ``mesh_blocks``), the same on every pod and data rank;
    * the batch (``tokens``, ``active``, ``frames``, ``patch_embeds``):
      its rows over the batch ranks (``("pod", "data")``, pod-major)
      where they divide (``rows``), replicated over ``model``; where the
      rows do not divide, every batch rank runs them all (the rules
      replicate them over pod and data alike), and moe routes them alone
      (its routing pool is the rank);
    * the decode state (``state_shardings``, the reference's
      ``decode_state_shardings``; ``place_state`` / ``gather_state``):
      ``cache_batch`` over ``("pod", "data")`` where it divides; the KV
      cache
      (``k``, ``v``, ``xk``, ``xv``) in one of two layouts, as the
      reference's rules give it: where the model axis divides the
      cache's positions, ``cache_seq`` over ``model``, every KV head a
      rank; where it does not, every position a rank, ``kv_heads`` over
      ``model`` where they divide, else every KV head (the cache whole
      on each rank); ``cache_len`` by rows;
    * the recurrent state (ssm, hybrid): where the rules shard
      ``ssm_heads`` over ``model``, ``ssm`` is the rank's heads (the
      reference's block) and ``conv`` the port's own block, the x
      channels of the rank's heads followed by B and C (the same on
      every model rank), the channels its tensor-parallel Mamba2 block
      reads (``mamba2.head_channels``; the reference cuts ``conv_dim``
      in equal blocks that do not follow them); where the rules
      replicate ``ssm_heads``, both whole on every model rank;
    * the logits replicated: gathered over the vocabulary's model blocks
      and the batch ranks' rows (``gather_logits``: over ``data``, then
      over ``pod``)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, mesh):
        sizes = axis_sizes(mesh)
        if set(sizes) - {"pod", "data", "model"}:
            raise ValueError(
                f"prefill and decode over a {sizes} mesh: the port serves "
                f"over ('data', 'model') and ('pod', 'data', 'model') "
                f"meshes")
        self.cfg, self.shape, self.mesh = cfg, shape, mesh
        self.coord = coordinate(mesh)
        rules = ShardingRules(mesh).with_cache(shape.seq_len)
        # this rank's coordinate on the batch group, and its size
        b, n = 0, 1
        for a in BATCH_AXES:
            b, n = b * sizes.get(a, 1) + self.coord.get(a, 0), \
                n * sizes.get(a, 1)
        if n > 1 and rules.mesh_axes_for("batch",
                                         shape.global_batch) is None:
            rules = rules.with_pool(b, 1)
        self.rules = rules
        self.state_shardings = decode_state_shardings(cfg, shape, rules)
        # the recurrent ``conv`` leaf: its rows (cache_batch) only, then
        # the rank's heads' channels where ``heads`` is (rank, size)
        self.heads = None
        if cfg.family in ("ssm", "hybrid"):
            conv = self.state_shardings.cache["conv"]
            self.conv_rows = conv._replace(spec=tuple(
                None if e == "model" else e for e in conv.spec))
            if _heads_split(cfg, rules):
                self.heads = (self.coord["model"], sizes["model"])

    def rows(self, t):
        """A global batch leaf -> this rank's rows of it (a view)."""
        return local_block(t, self.rules.sharding(
            ("batch",) + (None,) * (t.ndim - 1), t.shape), self.coord)

    def gather_logits(self, logits):
        """This rank's logits (its rows; its block of the vocabulary where
        the rules shard it, ``transformer.lm_logits``) -> the whole (B, S,
        padded_vocab), the same on every rank: all-gathered over the
        model and data axes that split them."""
        shape = (self.shape.global_batch, logits.shape[1],
                 self.cfg.padded_vocab)
        return gather_block(logits, self.rules.sharding(
            ("batch", None, "vocab"), shape))

    def place_state(self, state: DecodeState) -> DecodeState:
        """A whole decode state -> this rank's block of every leaf, each a
        copy of its own."""
        sh = self.state_shardings

        def own(k, t):
            if k != "conv":
                return local_block(t, sh.cache[k], self.coord).clone(
                    memory_format=torch.contiguous_format)
            t = local_block(t, self.conv_rows, self.coord)
            return (t.clone(memory_format=torch.contiguous_format)
                    if self.heads is None else
                    ssm_lib.head_channels(t, self.cfg, *self.heads))
        return DecodeState({k: own(k, v) for k, v in state.cache.items()},
                           local_block(state.cache_len, sh.cache_len,
                                       self.coord).clone())

    def gather_state(self, state: DecodeState) -> DecodeState:
        """``place_state``'s inverse: the whole decode state on every rank
        (all-gathers over the axes that split each leaf; the ``conv``
        blocks of the rank's heads joined by ``mamba2.whole_channels``)."""
        sh = self.state_shardings

        def whole(k, t):
            if k != "conv":
                return gather_block(t, sh.cache[k])
            if self.heads is not None:
                t = ssm_lib.whole_channels(gather_parts(
                    t, self.mesh.get_group("model"), self.heads[1]),
                    self.cfg)
            return gather_block(t, self.conv_rows)
        return DecodeState({k: whole(k, v) for k, v in state.cache.items()},
                           gather_block(state.cache_len, sh.cache_len))


def _mesh_rules(sm: Optional[ServingMesh]):
    """``sm``'s rules for the life of the block; the caller's as they are
    without a mesh."""
    return contextlib.nullcontext() if sm is None else use_rules(sm.rules)


def _decode_state(cfg: ModelConfig, shape: ShapeConfig,
                  fill_len: Optional[int], dev) -> DecodeState:
    B, S = shape.global_batch, shape.seq_len
    cache = (_recurrent_cache(cfg, B, dev) if cfg.family in ("ssm", "hybrid")
             else {})
    if cfg.family != "ssm":
        kv = (_attn_layers(cfg), B, S, cfg.num_kv_heads, cfg.head_dim)
        keys = ("k", "v", "xk", "xv") if cfg.family == "enc_dec" else (
            "k", "v")
        cache.update({k: torch.zeros(kv, dtype=torch.bfloat16, device=dev)
                      for k in keys})
    fl = S - 1 if fill_len is None else fill_len
    return DecodeState(cache, torch.full((B,), fl, dtype=torch.int32,
                                         device=dev))


# -------------------------------------------------------------- prefill
def _decoder_prefill(params, batch, cfg: ModelConfig, impl: str = "kernel"):
    """tokens (B, S) -> (final hidden (B, S', d), per-layer bf16 k, v);
    a vlm model's ``patch_embeds`` go in front (S' = frontend_seq + S)."""
    h = T.embed_tokens(params, batch["tokens"], cfg)
    if cfg.family == "vlm":
        h = T.prepend_patches(h, batch["patch_embeds"])
    ks, vs = [], []
    for lp in params["layers"]:
        h, (k, v) = L.attention_block(lp["attn"], h, cfg, causal=True,
                                      impl=impl)
        h = _feed_forward(lp, h, cfg)
        ks.append(L.cache_block(k.to(torch.bfloat16), cfg))
        vs.append(L.cache_block(v.to(torch.bfloat16), cfg))
    return h, ks, vs


def _encdec_prefill(params, batch, cfg: ModelConfig, impl: str = "kernel"):
    """frames (B, S, d), tokens (B, S) -> (the decoder's final hidden,
    cache): per decoder layer the self attention's bf16 k, v and the
    cross attention's bf16 xk, xv (the encoder output's projections)."""
    enc_out = T.encoder_forward(params, batch["frames"], cfg, impl=impl)
    h = T.embed_tokens(params, batch["tokens"], cfg)
    cols = {k: [] for k in ("k", "v", "xk", "xv")}
    for lp in params["dec_layers"]:
        h, (k, v) = L.attention_block(lp["self_attn"], h, cfg, causal=True,
                                      impl=impl)
        xk, xv, heads = T.cross_kv_heads(lp["cross_attn"], enc_out, cfg)
        h = T.cross_attention(lp["cross_attn"], h,
                              *L.expand_kv(xk, xv, heads), cfg)
        h = L.swiglu_block(lp["mlp"], h, cfg)
        for key, t in zip(cols, (k, v, xk, xv)):
            cols[key].append(L.cache_block(t.to(torch.bfloat16), cfg))
    return h, {k: torch.stack(ts) for k, ts in cols.items()}


def _ssm_prefill(params, tokens, cfg: ModelConfig, impl: str = "kernel"):
    """tokens (B, S) -> (final hidden, cache): per-layer SSD states
    (float32) and conv tails (rounded to bf16, in ``conv_dtype``),
    stacked as the cache leaves are, and
    for hybrid the shared block's bf16 k, v per period."""
    h = T.embed_tokens(params, tokens, cfg)
    shared = params.get("shared")
    sts, convs, ks, vs = [], [], [], []
    for _, layers in _mamba_layers(params, cfg):
        for _, lp in layers:
            h, (st, conv) = ssm_lib.mamba2_block(lp, h, cfg, impl=impl)
            sts.append(st.float())
            convs.append(_prefill_conv(conv, cfg))
        if shared is not None:
            h, (k, v) = L.attention_block(shared["attn"], h, cfg,
                                          causal=True, impl=impl)
            h = L.swiglu_block(shared["mlp"], h, cfg)
            ks.append(L.cache_block(k.to(torch.bfloat16), cfg))
            vs.append(L.cache_block(v.to(torch.bfloat16), cfg))
    lead = ((cfg.num_layers,) if cfg.family == "ssm"
            else (len(ks), cfg.attn_every))
    cache = {"ssm": torch.stack(sts).reshape(lead + sts[0].shape),
             "conv": torch.stack(convs).reshape(lead + convs[0].shape)}
    if shared is not None:
        cache.update(k=torch.stack(ks), v=torch.stack(vs))
    return h, cache


def make_prefill(cfg: ModelConfig, shape: ShapeConfig, impl: str = "kernel",
                 mesh=None):
    """Returns fn(params, batch) -> (last_logits, DecodeState).

    ``batch`` is ``batch_spec``'s prefill batch: ``tokens``, and an
    enc_dec model's ``frames`` or a vlm model's ``patch_embeds``.  Past
    8192 positions (or with ``cfg.attn_impl="blockwise"``) attention is
    ``blockwise_attention``: the flash-attention kernel on the card (the
    encoder's non-causal, the decoders' causal; enc_dec cross attention
    stays ``full_attention``).  Every kernel on the way (flash attention,
    SSD) runs its plain version on the CPU, or with ``impl="ref"``.
    ``cache_len`` is ``shape.seq_len``, as in the reference.

    ``mesh``: a ``("data", "model")`` or ``("pod", "data", "model")``
    ``DeviceMesh`` this rank belongs to; every rank of it must call the
    function, with its blocks of the
    parameters (``serving_params(..., mesh=mesh)``) and the **global**
    batch.  The rank runs its rows (``ServingMesh``) with the blocks
    tensor parallel over the model axis (attention on its heads: the
    flash kernel on them past 8192 positions; the Mamba2 blocks on its
    SSM heads, the SSD kernel on them; moe routed over the batch ranks
    with the experts laid out as the rules lay them), and returns what
    the reference's ``out_shardings`` give it: the logits replicated,
    (B, 1, padded_vocab) on every rank, and its block of the decode
    state in ``ServingMesh``'s layout (its rows; of the KV cache its
    ``S / m`` positions of every KV head, or, where ``m`` does not
    divide S, every position of its KV heads: ``layers.cache_block``;
    its heads' ``ssm`` and ``conv``)."""
    sm = None if mesh is None else ServingMesh(cfg, shape, mesh)

    def prefill(params, batch):
        if sm is not None:
            batch = {k: sm.rows(v) for k, v in batch.items()}
        with _mesh_rules(sm):
            if cfg.family in DECODER_FAMILIES:
                h, ks, vs = _decoder_prefill(params, batch, cfg, impl)
                cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
            elif cfg.family == "enc_dec":
                h, cache = _encdec_prefill(params, batch, cfg, impl)
            else:
                h, cache = _ssm_prefill(params, batch["tokens"], cfg, impl)
            logits = T.lm_logits(params, h[:, -1:], cfg)
        if sm is not None:
            logits = sm.gather_logits(logits)
        cache_len = torch.full((h.shape[0],), shape.seq_len,
                               dtype=torch.int32, device=h.device)
        return logits, DecodeState(cache, cache_len)

    return prefill


def make_bulk_prefill(cfg: ModelConfig, shape: ShapeConfig, chunk: int,
                      impl: str = "kernel"):
    """Chunked bulk prefill into one slot of a batched decode cache.

    Returns ``fn(params, state, tokens, slot, n_real) -> DecodeState``:
    prefills a ``(1, chunk)`` token buffer, writes the resulting cache
    columns into row ``slot`` (positions ``[0, chunk)`` of k/v; whole-row
    replacement of the recurrent ssm/conv leaves) and sets
    ``cache_len[slot] = n_real``.  ``slot`` and ``n_real`` are host ints.
    A chunk past 8192 tokens runs the flash-attention kernel on the card
    (``make_prefill``; ``impl="ref"``: the plain versions).  Only the
    ``BULK_PREFILL_FAMILIES`` have one: ``ValueError`` otherwise.
    """
    if cfg.family not in BULK_PREFILL_FAMILIES:
        raise ValueError(f"no bulk prefill for {cfg.family}")
    prefill = make_prefill(cfg, ShapeConfig(f"prefill_chunk{chunk}", chunk,
                                            1, "prefill"), impl)

    def bulk_prefill(params, state: DecodeState, tokens, slot: int,
                     n_real: int):
        _, pstate = prefill(params, {"tokens": tokens})
        for key, upd in pstate.cache.items():
            leaf = state.cache[key]
            if key in ("k", "v"):            # (L, 1, chunk, KV, D)
                leaf[:, slot, :chunk] = upd[:, 0]
            else:
                ax = lane_axis(cfg)
                leaf.select(ax, slot).copy_(upd.select(ax, 0))
        state.cache_len[slot].fill_(n_real)
        return state

    return bulk_prefill


# ------------------------------------------------- sync-free decode loop
@dataclasses.dataclass
class SampleState:
    """Device-resident continuous-batching state for the decode hot loop.

    Everything the per-step control flow needs lives on the device, so a
    multi-step decode window performs zero device->host transfers; the
    host reconciles progress from its own exact projection and fetches
    ``out_buf`` only at completion/drain boundaries.
    """
    next_tok: torch.Tensor   # (B, 1) int32 — token each slot feeds next step
    active: torch.Tensor     # (B,)  int32 — slot occupied and not finished
    fed: torch.Tensor        # (B,)  int32 — prompt+generated tokens fed so far
    plen: torch.Tensor       # (B,)  int32 — prompt length
    maxfed: torch.Tensor     # (B,)  int32 — fed value at which the slot is done
    out_buf: torch.Tensor    # (B, S) int32 — generated tokens at index fed-plen
    rng: torch.Generator     # device generator for temperature sampling


def init_sample_state(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                      device="cuda") -> SampleState:
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len

    def z(*shp):
        return torch.zeros(shp, dtype=torch.int32, device=dev)

    return SampleState(next_tok=z(B, 1), active=z(B), fed=z(B),
                       plen=torch.ones(B, dtype=torch.int32, device=dev),
                       maxfed=z(B), out_buf=z(B, S),
                       rng=torch.Generator(dev).manual_seed(seed))


def make_decode_loop(cfg: ModelConfig, shape: ShapeConfig, n_steps: int,
                     temperature: float = 0.0,
                     eos_token: Optional[int] = None, serve_step=None):
    """Fused sample-and-advance decode: ``n_steps`` serve steps with the
    sampling and continuous-batching bookkeeping on the device.

    ``serve_step`` injects an alternative per-token step with the same
    calling convention (paged engines pass ``make_paged_serve_step``'s);
    the bookkeeping body treats the cache state opaquely, so dense and
    paged loops share it.

    Returns ``fn(params, state, SampleState, prompt_buf) -> (state,
    SampleState)``.  Greedy decoding takes the first maximum, as
    ``jnp.argmax`` does.  Temperature sampling is Gumbel-max with the
    sample state's own ``torch.Generator``: a categorical draw like the
    reference's, from another random stream (so cross-package parity is
    greedy only).
    """
    if serve_step is None:
        serve_step = make_serve_step(cfg, shape)
    S = shape.seq_len

    def decode_loop(params, state, s: SampleState, prompt_buf):
        for _ in range(n_steps):
            logits, state = serve_step(params, state, s.next_tok, s.active)
            last = logits[:, -1, :]
            if temperature > 0:
                u = torch.rand(last.shape, generator=s.rng,
                               device=last.device).clamp_(min=1e-20)
                sampled = torch.argmax(
                    last.float() / temperature - torch.log(-torch.log(u)),
                    dim=-1)
            else:
                sampled = torch.argmax(last, dim=-1)
            sampled = sampled.to(torch.int32)
            act = s.active > 0
            fed2 = s.fed + s.active
            generating = act & (fed2 >= s.plen)
            oi = (fed2 - s.plen).clamp(0, S - 1).long()[:, None]
            cur = s.out_buf.gather(1, oi)[:, 0]
            s.out_buf.scatter_(1, oi, torch.where(generating, sampled,
                                                  cur)[:, None])
            prompt_tok = prompt_buf.gather(
                1, fed2.clamp(0, S - 1).long()[:, None])[:, 0]
            nxt = torch.where(fed2 < s.plen, prompt_tok, sampled)
            next_tok = torch.where(act[:, None], nxt[:, None], s.next_tok)
            done = generating & (fed2 >= s.maxfed)
            if eos_token is not None:
                done = done | (generating & (sampled == eos_token))
            active = s.active * (1 - done.to(torch.int32))
            s = SampleState(next_tok, active, fed2, s.plen, s.maxfed,
                            s.out_buf, s.rng)
        return state, s

    return decode_loop


# -------------------------------------------------------------- decode
def _layer_stack(params, cache, h, cfg: ModelConfig, attention, *,
                 act=None, slot: Optional[int] = None, fresh: bool = False,
                 impl: str = "kernel"):
    """The model's layers over ``h``, caches updated in place.  Every
    attention is ``attention(attn params, h, index of its k/v leaves) ->
    h``: each dense, vlm or moe layer's (then its MLP or MoE block), each
    enc_dec decoder layer's self attention (then its cross attention over
    the whole ``xk``/``xv`` and its MLP), and the hybrid shared block's
    at the end of each period.

    Mamba2 layers, decode (``slot`` None): one token per lane, each layer
    steps its lanes' states (lanes with ``act`` False keep theirs).  Chunk
    prefill (``slot`` given): the chunk continues lane ``slot``'s states,
    or starts from zeros when ``fresh``, and they are replaced whole, the
    conv tail rounded to bf16 as every prefill rounds it.
    """
    if cfg.family in DECODER_FAMILIES:
        for i, lp in enumerate(params["layers"]):
            h = attention(lp["attn"], h, i)
            h = _feed_forward(lp, h, cfg)
        return h
    if cfg.family == "enc_dec":
        for i, lp in enumerate(params["dec_layers"]):
            h = attention(lp["self_attn"], h, i)
            h = T.decode_cross_attention(lp["cross_attn"], h, cache["xk"][i],
                                         cache["xv"][i], cfg)
            h = L.swiglu_block(lp["mlp"], h, cfg)
        return h
    shared = params.get("shared")
    for period, layers in _mamba_layers(params, cfg):
        for idx, lp in layers:
            ssm, conv = cache["ssm"][idx], cache["conv"][idx]  # (B, ...)
            if slot is None:
                h, (st, cv) = ssm_lib.mamba2_block(
                    lp, h, cfg, ssm_state=ssm, conv_state=conv, active=act)
            else:
                ssm, conv = ssm[slot:slot + 1], conv[slot:slot + 1]
                h, (st, cv) = ssm_lib.mamba2_block(
                    lp, h, cfg, impl=impl,
                    init_ssm=None if fresh else ssm,
                    init_conv=None if fresh else conv)
                cv = _prefill_conv(cv, cfg)
            ssm.copy_(st)
            conv.copy_(cv)
        if shared is not None:
            h = attention(shared["attn"], h, period)
            h = L.swiglu_block(shared["mlp"], h, cfg)
    return h


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """Returns fn(params, DecodeState, tokens (B,1), active (B,)) ->
    (logits, DecodeState): one new token per sequence against a cache
    of ``shape.seq_len``.

    ``mesh``: as ``make_prefill``'s.  Every rank of the mesh calls the
    step with its blocks of the parameters and of the decode state
    (``ServingMesh.place_state``, or a prefill's over the same mesh) and
    the **global** ``tokens`` / ``active``; it returns the logits
    replicated and its block of the new state.  Each attention follows
    the cache's layout (``layers.decode_attention``; enc_dec's cross
    attention ``transformer.decode_cross_attention``), the reference's
    ``kv_len = cache_len + 1`` function: where the model axis divides
    the cache's positions, a split softmax over the ranks' positions,
    and only the rank that owns a lane's position ``cache_len`` writes
    it; where it does not, tensor-parallel attention over every
    position of the rank's KV heads, which every rank writes.  Each
    Mamba2 block steps the rank's heads' states (``mamba2_block``:
    ``ssm_norm``'s squares and ``out_proj`` all-reduced over the model
    ranks)."""
    sm = None if mesh is None else ServingMesh(cfg, shape, mesh)

    def serve_step(params, state: DecodeState, tokens, active=None):
        if active is None:
            active = torch.ones(tokens.shape[0], dtype=torch.int32,
                                device=tokens.device)
        if sm is not None:
            tokens, active = sm.rows(tokens), sm.rows(active)
        act = active.bool()
        cache, clen = state.cache, state.cache_len

        def attention(p, x, i):
            x, _ = L.decode_attention(p, x, cfg, cache_k=cache["k"][i],
                                      cache_v=cache["v"][i], cache_len=clen,
                                      active=act)
            return x

        with _mesh_rules(sm):
            h = T.embed_tokens(params, tokens, cfg)
            h = _layer_stack(params, cache, h, cfg, attention, act=act)
            logits = T.lm_logits(params, h, cfg)
        if sm is not None:
            logits = sm.gather_logits(logits)
        return logits, DecodeState(cache, clen + active)

    return serve_step


# ============================================================ paged cache
@dataclasses.dataclass
class PagedDecodeState:
    """Decode state over a *paged* KV cache (vLLM-style block pool).

    KV leaves are one shared pool ``(L, num_blocks + 1, block_size, KV,
    D)``: ``num_blocks`` live rows plus the sink row.  Each lane
    addresses its logical positions through ``block_tables`` (B,
    max_blocks) of physical pool rows.  Unallocated table entries hold
    the sentinel ``num_blocks``: gathers clamp it (garbage always masked
    by kv_len / causality), writes land in the sink row, so stale tables
    never corrupt live blocks.  Hybrid has one pool per period, ssm none;
    their recurrent leaves (ssm/conv) stay lane-indexed.
    """
    cache: Dict[str, torch.Tensor]
    cache_len: torch.Tensor     # (B,) filled positions
    block_tables: torch.Tensor  # (B, max_blocks) int32 physical pool rows


def init_paged_decode_state(cfg: ModelConfig, shape: ShapeConfig,
                            block_size: int, num_blocks: int,
                            device="cuda") -> PagedDecodeState:
    _paged(cfg)
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    if S % block_size:
        raise ValueError(f"seq_len {S} not a multiple of {block_size}")
    mb = S // block_size
    cache = ({} if cfg.family in DECODER_FAMILIES
             else _recurrent_cache(cfg, B, dev))
    for key in paged_kv_keys(cfg):
        cache[key] = torch.zeros(
            (_attn_layers(cfg), num_blocks + 1, block_size,
             cfg.num_kv_heads, cfg.head_dim), dtype=torch.bfloat16,
            device=dev)
    return PagedDecodeState(
        cache, torch.zeros(B, dtype=torch.int32, device=dev),
        torch.full((B, mb), num_blocks, dtype=torch.int32, device=dev))


def make_paged_serve_step(cfg: ModelConfig, shape: ShapeConfig,
                          block_size: int, num_blocks: int,
                          impl: str = "kernel"):
    """Paged ``make_serve_step``: fn(params, PagedDecodeState, tokens,
    active) -> (logits, PagedDecodeState).  Same sampling-visible math as
    the dense step; the attention core is the CUDA kernel on the card
    and the plain version on the CPU (or with ``impl="ref"``).  In the
    hybrid family the shared block's attention is the step's only one."""
    _paged(cfg)

    def serve_step(params, state: PagedDecodeState, tokens, active=None):
        if active is None:
            active = torch.ones(tokens.shape[0], dtype=torch.int32,
                                device=tokens.device)
        act = active.bool()
        h = T.embed_tokens(params, tokens, cfg)
        cache, clen, bt = state.cache, state.cache_len, state.block_tables

        def attention(p, x, i):
            x, _ = L.paged_decode_attention(
                p, x, cfg, pool_k=cache["k"][i], pool_v=cache["v"][i],
                block_tables=bt, cache_len=clen, active=act, impl=impl)
            return x

        h = _layer_stack(params, cache, h, cfg, attention, act=act)
        logits = T.lm_logits(params, h, cfg)
        return logits, PagedDecodeState(cache, clen + active, bt)

    return serve_step


def make_paged_decode_loop(cfg: ModelConfig, shape: ShapeConfig,
                           n_steps: int, block_size: int, num_blocks: int,
                           temperature: float = 0.0,
                           eos_token: Optional[int] = None):
    """``make_decode_loop`` over a paged cache — shares the exact
    sampling/bookkeeping body with the dense loop."""
    step = make_paged_serve_step(cfg, shape, block_size, num_blocks)
    return make_decode_loop(cfg, shape, n_steps, temperature=temperature,
                            eos_token=eos_token, serve_step=step)


def make_paged_bulk_prefill(cfg: ModelConfig, shape: ShapeConfig,
                            chunk: int, block_size: int, num_blocks: int,
                            first_chunk: bool = False, impl: str = "kernel"):
    """State-continued chunk prefill into one slot of a paged cache.

    Returns ``fn(params, state, tokens, slot, off, n_real) ->
    PagedDecodeState``: prefills a ``(1, chunk)`` token buffer whose
    first token sits at absolute position ``off`` of slot ``slot``.
    Attention kv lands in the slot's blocks through its table; attention
    reads causally over history + chunk.  Recurrent (ssm/conv) leaves
    continue from the slot's carried state — zeros when ``off == 0`` —
    through the SSD ``init_state``: exactly one long prefill over the
    concatenated chunks.  The SSD core is the CUDA kernel on the card and
    the plain version on the CPU (or with ``impl="ref"``).
    ``first_chunk=True`` is the ``off == 0`` specialization that skips
    the history gather.  Sets ``cache_len[slot] = off + n_real``.
    ``slot``/``off``/``n_real`` are host ints, so the ``off == 0`` choice
    is a Python branch with no sync.
    """
    _paged(cfg)

    def paged_prefill(params, state: PagedDecodeState, tokens, slot: int,
                      off: int, n_real: int):
        bt_row = state.block_tables[slot]
        cache = state.cache
        h = T.embed_tokens(params, tokens, cfg)

        def attention(p, x, i):
            x, _, _ = L.paged_chunk_attention(
                p, x, cfg, pool_k=cache["k"][i], pool_v=cache["v"][i],
                bt_row=bt_row, off=off, history=not first_chunk)
            return x

        _layer_stack(params, cache, h, cfg, attention, slot=slot,
                     fresh=first_chunk or off == 0, impl=impl)
        state.cache_len[slot].fill_(off + n_real)
        return state

    return paged_prefill
