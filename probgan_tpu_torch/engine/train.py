"""Training steps: one eager G/D adversarial step for each model family.

The port of ``probgan_tpu/engine/train.py``. The losses are the JAX package's:

- non-saturating logistic GAN losses (softplus form) for both families;
- ProGAN: plain NS-GAN on images at the active (stage, alpha), optionally
  with the R1 penalty on reals;
- KG-GAN: the discriminator separates true tails from generated tails, and
  from corrupted tails and relations, with the tables frozen; the generator,
  trained JOINTLY with the entity and relation tables, fools it and minimizes
  a ranking cross-entropy over the entity table plus a cosine pull.

Every step is a pure (state, batch) -> (state, metrics) function over trees
of tensors: it returns a new state and leaves the one it was given untouched,
so a caller may keep both (and a resumed run repeats an uninterrupted one).
States live on the device that ``*_init_state`` was given, the card by
default. The steps run eagerly. Metrics are 0-d tensors on that device.

Adam is written out over the leaves (``optax.adam`` and ``torch.optim.Adam``
share the formula m_hat / (sqrt(v_hat) + eps)); its state has ``optax``'s
shape, ``(ScaleByAdamState(count, mu, nu), EmptyState())``, so that a train
state file of either package resumes in the other (``core/train_state.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from probgan_tpu_torch.core.device import resolve_device
from probgan_tpu_torch.core.rng import RngStream
from probgan_tpu_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from probgan_tpu_torch.models import kg_gan, pro_gan
from probgan_tpu_torch.ops import rank as rank_ops


# ---------------------------------------------------------------------------
# Adam over a tree
# ---------------------------------------------------------------------------

class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar, kept on the CPU: updates taken so far
    mu: dict | tuple     # first moments, the parameters' tree
    nu: dict | tuple     # second moments


class EmptyState(NamedTuple):
    """The state of optax.adam's second link (the learning-rate scale)."""


class Adam(NamedTuple):
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def adam_init(params) -> tuple:
    return (
        ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        ),
        EmptyState(),
    )


def adam_update(opt: Adam, params, grads, opt_state: tuple):
    """One Adam update: returns (new params, new state), all new tensors."""
    state = opt_state[0]
    p, g = tree_leaves(params), tree_leaves(grads)
    mu = torch._foreach_mul(tree_leaves(state.mu), opt.b1)
    torch._foreach_add_(mu, g, alpha=1.0 - opt.b1)
    nu = torch._foreach_mul(tree_leaves(state.nu), opt.b2)
    torch._foreach_addcmul_(nu, g, g, value=1.0 - opt.b2)
    count = state.count + 1
    n = int(count)  # on the CPU: reading it waits for nothing on the card
    # m_hat / (sqrt(v_hat) + eps) with the bias corrections folded in
    denom = torch._foreach_div(nu, 1.0 - opt.b2 ** n)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, opt.eps)
    new_p = torch._foreach_addcdiv(p, mu, denom, value=-opt.lr / (1.0 - opt.b1 ** n))
    new_state = ScaleByAdamState(count, tree_unflatten(state.mu, mu),
                                 tree_unflatten(state.nu, nu))
    return tree_unflatten(params, new_p), (new_state, EmptyState())


def _grads(loss: torch.Tensor, params) -> list:
    """d loss / d leaf for every leaf; zeros for a leaf the loss does not
    reach (an inactive stage's weights), as ``jax.grad`` gives."""
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def _trainable(params):
    """The same values as fresh leaves that record gradients."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


# ---------------------------------------------------------------------------
# ProGAN (image) step
# ---------------------------------------------------------------------------

class ProGANTrainState(NamedTuple):
    g_params: dict
    d_params: dict
    g_opt: tuple
    d_opt: tuple
    # Exponential moving average of g_params; serving prefers it when present
    # (core/image_checkpoint.py). Last, so that a file from before the EMA
    # upgrades by key injection (load_train_state's alias_missing).
    g_ema: dict


def progan_optimizer(lr: float = 1e-3) -> Adam:
    # ProGAN's Adam settings (b1 = 0 stabilizes adversarial training).
    return Adam(lr, b1=0.0, b2=0.99, eps=1e-8)


def _to_device(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def progan_init_state(generator: torch.Generator | int, config: pro_gan.ProGANConfig,
                      lr: float = 1e-3, device: str = "auto") -> ProGANTrainState:
    """A fresh train state on ``device`` (the card unless "cpu" is asked for),
    weights drawn from ``generator`` (or a seed) on the CPU: the bits do not
    depend on the device. ``g_ema`` starts as ``g_params`` itself."""
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    dev = resolve_device(device)
    g_params = _to_device(pro_gan.init_generator(config, generator), dev)
    d_params = _to_device(pro_gan.init_discriminator(config, generator), dev)
    return ProGANTrainState(g_params, d_params, adam_init(g_params), adam_init(d_params),
                            g_params)


# The grade of a step's unpacked convs and of its forward-only fake render,
# named by ``packed_train_mode``: "default" (one bf16 pass in the kernels)
# goes with TF32 (models/pro_gan.py _PRECISIONS: the JAX step runs its XLA
# convs at that class, Precision.DEFAULT, whatever the mode), the others with
# fp32. The default mode is "default", as in the JAX package: a step takes
# TF32 and the bf16 kernels unless asked for "high" or "highest".
_STEP_PRECISION = {"default": "default", "mid": "high", "high": "high", "highest": "highest"}


def _progan_loss_fns(g_ref_params, config, stage, alpha, dtype, packed_fake, remat,
                     packed_d, packed_g, packed_train_mode, axis_names=None, r1_gamma=0.0):
    """The two loss closures both step variants differentiate.

    ``d_loss_fn(d_params, real, z)``: non-saturating D loss; the fake batch
    renders from ``g_ref_params`` under ``no_grad``.
    ``g_loss_fn(g_params, d_params, z)``: the fool-D generator loss against
    the given (already updated) discriminator.

    ``r1_gamma > 0`` adds the R1 zero-centered gradient penalty on reals
    (gamma/2 * E[||grad_x D(x)||^2]). Differentiating it with respect to
    d_params is a second-order use of D, which the kernels' Functions do not
    support (their backward is not itself differentiable), so the penalty
    always evaluates D through the unpacked path; the main loss terms keep
    whatever path was configured.

    ``axis_names``: the process group over which the batch is split, or
    None; every discriminator pass (the R1 penalty's too) takes its
    minibatch-stddev statistics over the whole batch."""
    d_mode = packed_train_mode if packed_d else None
    g_mode = packed_train_mode if packed_g else None
    prec = _STEP_PRECISION[packed_train_mode]

    def r1_penalty(d_params, real_images):
        imgs = real_images.detach().float().requires_grad_(True)
        logits = pro_gan.discriminator_apply(d_params, imgs, config, stage, alpha, dtype,
                                             prec, remat=remat, stddev_axis=axis_names)
        (g,) = torch.autograd.grad(logits.float().sum(), imgs, create_graph=True)
        return g.square().sum(dim=(1, 2, 3)).mean()

    def d_loss_fn(d_params, real_images, z):
        with torch.no_grad():
            fake = pro_gan.generator_rgb(g_ref_params, z, config, stage, alpha, dtype, prec,
                                         packed=packed_fake, packed_mode=g_mode)
        # Logits go to fp32 before the loss: with dtype bfloat16 the convs run
        # in bf16 and the loss math in fp32, as in the JAX step.
        real_logits = pro_gan.discriminator_apply(
            d_params, real_images, config, stage, alpha, dtype, prec, remat=remat,
            packed=packed_d, stddev_axis=axis_names, packed_mode=d_mode).float()
        fake_logits = pro_gan.discriminator_apply(
            d_params, fake, config, stage, alpha, dtype, prec, remat=remat, packed=packed_d,
            stddev_axis=axis_names, packed_mode=d_mode).float()
        loss = F.softplus(-real_logits).mean() + F.softplus(fake_logits).mean()
        if r1_gamma > 0.0:
            loss = loss + 0.5 * r1_gamma * r1_penalty(d_params, real_images)
        return loss, (real_logits.mean().detach(), fake_logits.mean().detach())

    def g_loss_fn(g_params, d_params, z):
        fake = pro_gan.generator_rgb(g_params, z, config, stage, alpha, dtype, prec,
                                     remat=remat, packed_mode=g_mode)
        fake_logits = pro_gan.discriminator_apply(
            d_params, fake, config, stage, alpha, dtype, prec, remat=remat, packed=packed_d,
            stddev_axis=axis_names, packed_mode=d_mode).float()
        return F.softplus(-fake_logits).mean()

    return d_loss_fn, g_loss_fn


def _check_step_args(packed_train_mode, axis_names) -> str:
    """The step's grade (``_STEP_PRECISION``); raises for a mode the step
    does not have and for ``axis_names`` that is not a process group."""
    if packed_train_mode not in _STEP_PRECISION:
        raise ValueError(f"packed_train_mode {packed_train_mode!r} is not one of "
                         f"{tuple(_STEP_PRECISION)}")
    if axis_names is not None and not isinstance(axis_names, dist.ProcessGroup):
        raise TypeError(f"axis_names must be a torch.distributed process group "
                        f"(parallel/mesh.py:mesh_group), not {axis_names!r}")
    return _STEP_PRECISION[packed_train_mode]


def _mean_over_ranks(group, leaves: list, scalars: tuple) -> tuple[list, tuple]:
    """(leaves, scalars) averaged over ``group``'s ranks through ONE sum
    all-reduce of one flat fp32 buffer, then / the group's size: JAX's
    ``pmean`` of a tree. With equal shares of the batch on every rank, the
    mean of the ranks' gradients is the gradient of the whole batch's loss."""
    sizes = [t.numel() for t in leaves]
    flat = torch.cat([t.reshape(-1).float() for t in leaves]
                     + [torch.stack([s.float() for s in scalars])])
    dist.all_reduce(flat, group=group)
    flat = flat / dist.get_world_size(group)
    parts = flat.split(sizes + [len(scalars)])
    return ([p.view_as(t).to(t.dtype) for p, t in zip(parts, leaves)],
            tuple(parts[-1].unbind()))


def _ema(g_ema, g_params, ema_beta: float):
    if ema_beta == 0.0:  # EMA disabled: alias, do not materialize
        return g_params
    return tree_map(lambda e, p: torch.lerp(p, e, ema_beta), g_ema, g_params)


def _d_grads(d_loss_fn, d_params, real_images, z):
    """(gradient leaves, (d_loss, real_mean, fake_mean)) of the D loss."""
    req = _trainable(d_params)
    loss, aux = d_loss_fn(req, real_images, z)
    return _grads(loss, req), (loss.detach(), *aux)


def _g_grads(g_loss_fn, g_params, d_params, z):
    """(gradient leaves, g_loss) of the G loss against ``d_params``."""
    req = _trainable(g_params)
    loss = g_loss_fn(req, d_params, z)
    return _grads(loss, req), loss.detach()


def progan_grads(state: ProGANTrainState, real_images, z, alpha, config, stage, *,
                 dtype=torch.float32, packed_fake=False, remat=True, packed_d=False,
                 packed_g=False, packed_train_mode="default", r1_gamma=0.0):
    """The raw gradients of the two losses ``progan_train_step`` feeds to
    Adam, both at the state's own parameters, as trees: (d_grads, g_grads,
    metrics). For comparing paths (kernels, plain twins, unpacked) where the
    parameters after Adam are the wrong observable: a first Adam update is
    sign-like."""
    prec = _check_step_args(packed_train_mode, None)
    d_loss_fn, g_loss_fn = _progan_loss_fns(
        state.g_params, config, stage, alpha, dtype, packed_fake, remat, packed_d, packed_g,
        packed_train_mode, r1_gamma=r1_gamma)
    with pro_gan.precision_scope(prec):  # the backward's convs too
        d_grads, (d_loss, real_mean, fake_mean) = _d_grads(
            d_loss_fn, state.d_params, real_images, z)
        g_grads, g_loss = _g_grads(g_loss_fn, state.g_params, state.d_params, z)
    metrics = {"d_loss": d_loss, "g_loss": g_loss, "real_logit": real_mean,
               "fake_logit": fake_mean}
    return (tree_unflatten(state.d_params, d_grads),
            tree_unflatten(state.g_params, g_grads), metrics)


def progan_train_step(
    state: ProGANTrainState,
    real_images: torch.Tensor,
    z: torch.Tensor,
    alpha,
    config: pro_gan.ProGANConfig,
    stage: int,
    lr: float = 1e-3,
    dtype=torch.float32,
    ema_beta: float = 0.999,
    packed_fake: bool = False,
    remat: bool = True,
    packed_d: bool = False,
    packed_g: bool = False,
    packed_train_mode: str = "default",
    axis_names: dist.ProcessGroup | None = None,
    r1_gamma: float = 0.0,
):
    """One non-saturating G/D step at (stage, alpha). ``real_images`` are
    float in [-1, 1] at the stage's resolution, NHWC; ``z`` is [B, latent_dim];
    both on the state's device. ``ema_beta`` is the generator-EMA decay (0
    tracks the raw iterate). The D update lands before the G gradients are
    taken, and D's parameters enter the G step detached.

    ``packed_fake``: render the D step's fake batch with the forward-only
    kernels (legal: it runs under ``no_grad``). ``packed_d`` / ``packed_g``:
    run the late stages of D / G on the kernels, forward AND backward
    (ops/packed_vjp.py); ``packed_g`` supersedes ``packed_fake``.
    ``packed_train_mode``: the step's grade. With ``packed_d``/``packed_g``
    it is the kernels' grade: "default" (the JAX package's default, one bf16
    pass forward and backward, the weight gradient too), the 2-term split
    "mid" (the weight gradient fp32, as in the JAX package) or the fp32
    kernels ("high", "highest"). It also sets the grade of the unpacked convs
    and of the fake render (``_STEP_PRECISION``): "default" takes TF32, the
    others fp32.
    ``dtype``: float32, or bfloat16 (params, Adam and the loss math stay
    fp32): the unpacked convs run in bf16, and the packed kernels on fp32
    casts of the bf16 activations, their outputs cast back, as in the JAX
    package (``--fast`` is bf16 with both packed gates at "default").
    ``remat``: checkpoint each unpacked stage block (models/pro_gan.py); it
    changes no number.
    ``axis_names``: the process group over which the batch is split when
    this step runs on one rank of a data-parallel mesh
    (parallel/dp_train.py), else None. The discriminator's minibatch-stddev
    statistics are then taken over the whole batch, and the gradients and
    the four metrics are averaged over the ranks (one all-reduce a network):
    with equal shares that is the gradient of the whole batch's loss, so
    every rank takes the same Adam update and the parameters stay
    replicated with no broadcast."""
    prec = _check_step_args(packed_train_mode, axis_names)
    opt = progan_optimizer(lr)
    d_loss_fn, g_loss_fn = _progan_loss_fns(
        state.g_params, config, stage, alpha, dtype, packed_fake, remat, packed_d, packed_g,
        packed_train_mode, axis_names, r1_gamma)

    with pro_gan.precision_scope(prec):  # the backward's convs too
        d_grads, d_values = _d_grads(d_loss_fn, state.d_params, real_images, z)
        if axis_names is not None:
            d_grads, d_values = _mean_over_ranks(axis_names, d_grads, d_values)
        d_loss, real_mean, fake_mean = d_values
        d_params, d_opt = adam_update(opt, state.d_params, d_grads, state.d_opt)
        g_grads, g_loss = _g_grads(g_loss_fn, state.g_params, d_params, z)
        if axis_names is not None:
            g_grads, (g_loss,) = _mean_over_ranks(axis_names, g_grads, (g_loss,))
        g_params, g_opt = adam_update(opt, state.g_params, g_grads, state.g_opt)

    metrics = {"d_loss": d_loss, "g_loss": g_loss, "real_logit": real_mean,
               "fake_logit": fake_mean}
    return ProGANTrainState(g_params, d_params, g_opt, d_opt,
                            _ema(state.g_ema, g_params, ema_beta)), metrics


def progan_train_step_accum(
    state: ProGANTrainState,
    real_images: torch.Tensor,
    z: torch.Tensor,
    alpha,
    config: pro_gan.ProGANConfig,
    stage: int,
    lr: float = 1e-3,
    dtype=torch.float32,
    ema_beta: float = 0.999,
    packed_fake: bool = False,
    remat: bool = True,
    packed_d: bool = False,
    packed_g: bool = False,
    packed_train_mode: str = "default",
    r1_gamma: float = 0.0,
):
    """``progan_train_step`` with gradient accumulation: ``real_images`` is
    [A, B, R, R, 3] and ``z`` is [A, B, latent_dim]: A microbatches whose
    gradients average before each single optimizer update, one microbatch of
    activations alive at a time. The same math as one step on the A*B batch
    with one deliberate exception: the discriminator's minibatch-stddev
    statistics are per MICROBATCH. Both G and D see every microbatch before
    their one update, and the D update still lands before the G gradients are
    taken."""
    prec = _check_step_args(packed_train_mode, None)
    opt = progan_optimizer(lr)
    d_loss_fn, g_loss_fn = _progan_loss_fns(
        state.g_params, config, stage, alpha, dtype, packed_fake, remat, packed_d, packed_g,
        packed_train_mode, r1_gamma=r1_gamma)
    n_accum = real_images.shape[0]
    inv = 1.0 / n_accum

    def mean_over_microbatches(grads_and_values):
        total, sums = None, None
        for i in range(n_accum):
            grads, vals = grads_and_values(i)
            total = grads if total is None else torch._foreach_add(total, grads)
            sums = vals if sums is None else tuple(s + v for s, v in zip(sums, vals))
        return torch._foreach_mul(total, inv), tuple(s * inv for s in sums)

    with pro_gan.precision_scope(prec):  # the backward's convs too
        d_grads, (d_loss, real_mean, fake_mean) = mean_over_microbatches(
            lambda i: _d_grads(d_loss_fn, state.d_params, real_images[i], z[i]))
        d_params, d_opt = adam_update(opt, state.d_params, d_grads, state.d_opt)

        def g_micro(i):
            grads, loss = _g_grads(g_loss_fn, state.g_params, d_params, z[i])
            return grads, (loss,)

        g_grads, (g_loss,) = mean_over_microbatches(g_micro)
        g_params, g_opt = adam_update(opt, state.g_params, g_grads, state.g_opt)

    metrics = {"d_loss": d_loss, "g_loss": g_loss, "real_logit": real_mean,
               "fake_logit": fake_mean}
    return ProGANTrainState(g_params, d_params, g_opt, d_opt,
                            _ema(state.g_ema, g_params, ema_beta)), metrics


# ---------------------------------------------------------------------------
# KG-GAN (link prediction) step
# ---------------------------------------------------------------------------

class KGTrainState(NamedTuple):
    node_emb: torch.Tensor   # [N, D] trainable entity table
    rel_emb: torch.Tensor    # [R, D] trainable relation table
    g_params: dict
    d_params: dict
    g_opt: tuple             # optimizes (g_params, node_emb, rel_emb)
    d_opt: tuple             # optimizes d_params


def kg_optimizer(lr: float = 1e-3) -> Adam:
    return Adam(lr)


def kg_init_state(generator: torch.Generator | int, num_entities: int, num_relations: int,
                  embed_dim: int = 128, noise_dim: int = 64, hidden_dim: int = 1024,
                  lr: float = 1e-3, device: str = "auto") -> KGTrainState:
    """A fresh KG train state on ``device`` (the card unless "cpu" is asked
    for), drawn from ``generator`` (or a seed) on the CPU."""
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    dev = resolve_device(device)
    node_emb = (torch.randn((num_entities, embed_dim), generator=generator) * 0.1).to(dev)
    rel_emb = (torch.randn((num_relations, embed_dim), generator=generator) * 0.1).to(dev)
    g_params = _to_device(kg_gan.init_generator(generator, embed_dim, noise_dim), dev)
    d_params = _to_device(kg_gan.init_discriminator(generator, embed_dim, hidden_dim), dev)
    return KGTrainState(node_emb, rel_emb, g_params, d_params,
                        adam_init((g_params, node_emb, rel_emb)), adam_init(d_params))


_CE_TEMPERATURE = 0.1


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def _rank_ce(pred: torch.Tensor, node_emb: torch.Tensor, t_idx: torch.Tensor) -> torch.Tensor:
    """Full-softmax cross-entropy of temperature-scaled cosine logits against
    the true tail: the differentiable surrogate of Hit@k ranking."""
    logits = rank_ops.cosine_scores(
        rank_ops.l2_normalize(pred), rank_ops.l2_normalize(node_emb)) / _CE_TEMPERATURE
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, t_idx[:, None]).mean()


def _sampled_rank_ce(pred: torch.Tensor, node_emb: torch.Tensor, t_idx: torch.Tensor,
                     neg_ids: torch.Tensor, take=_take) -> torch.Tensor:
    """Sampled-softmax ranking cross-entropy: the full [B, N] logit matrix is
    O(B*N) per step; here the softmax runs over {true tail} U {S shared
    sampled negatives}. Negatives that collide with a row's true tail are
    masked so the label class is unique. ``take(table, ids)`` looks the rows
    up (on a mesh, the row-sharded table's lookup)."""
    pred_n = rank_ops.l2_normalize(pred)
    true_emb = rank_ops.l2_normalize(take(node_emb, t_idx))    # [B, D]
    neg_emb = rank_ops.l2_normalize(take(node_emb, neg_ids))   # [S, D]
    true_logit = (pred_n * true_emb).sum(dim=1, keepdim=True)
    neg_logits = rank_ops.cosine_scores(pred_n, neg_emb)  # [B, S]
    collide = neg_ids[None, :] == t_idx[:, None]
    neg_logits = neg_logits.masked_fill(collide, float("-inf"))
    logits = torch.cat([true_logit, neg_logits], dim=1) / _CE_TEMPERATURE
    return -F.log_softmax(logits, dim=-1)[:, 0].mean()


def kg_train_step(
    state: KGTrainState,
    triplets: torch.Tensor,  # [B, 3] int (h, r, t) positive triplets
    generator: torch.Generator | RngStream | None = None,
    lr: float = 1e-3,
    cosine_weight: float = 1.0,
    ce_weight: float = 1.0,
    adv_weight: float = 0.1,
    negatives: torch.Tensor | None = None,     # [B, 2] (corrupt tail, corrupt rel)
    ce_negatives: torch.Tensor | None = None,  # [S] sampled-softmax entity ids
    z: torch.Tensor | None = None,
    mesh=None,
):
    """One adversarial step on a batch of positive triplets.

    The discriminator separates true triplets from THREE kinds of negatives:
    generator fakes (h, r, G(h,r,z)), corrupted tails (h, r, t') and corrupted
    relations (h, r', t), with the tables frozen. ``negatives`` carries the
    corrupted ids; None keeps the fakes-only loss. Then G and the embedding
    tables train jointly, under one optimizer, on fool-D + ranking
    cross-entropy + cosine reconstruction. ``ce_negatives`` switches the CE
    from the full softmax over all N entities to a sampled softmax over S
    shared negatives, which production N needs.

    The generator's noise [B, noise_dim] is ``z`` when given (a test replays
    the JAX package's draw this way), else a standard-normal draw from
    ``generator``: a ``torch.Generator`` (drawn on its own device) or the
    port's ``RngStream`` (task "kg_train").

    ``mesh``: the run's ``parallel/sharded_kg.py:KGMesh`` (``kg_mesh``: a
    (data, model) ``DeviceMesh`` over a launched world and the table's row
    count), with ``state`` this rank's part of a row-sharded state
    (``parallel/dp_train.py:shard_kg_state``). ``triplets`` and
    ``negatives`` are then this rank's rows of the global batch along
    "data" (``dp_train.kg_batch_sharding``), ``ce_negatives`` the whole set
    and ``z`` the global batch's noise (or drawn for it from ``generator``,
    the same on every rank), of which the step takes this rank's rows. The
    rows come from their owners, each loss term is the mean over the global
    batch (the ranks' means averaged over "data": equal shares), and the
    gradients of the replicated leaves and of the table shard are averaged
    over "data", one all-reduce of one flat buffer a network, with the
    metrics. Adam then runs on every rank's leaves, the shard's rows
    included: dense, as optax's. Returns this rank's new state and the
    global batch's metrics, the same on every rank."""
    opt = kg_optimizer(lr)
    device = state.node_emb.device
    noise_dim = kg_gan.generator_dims(state.g_params)[1]
    if mesh is not None:
        mesh.require_shard(state.node_emb)
    take = _take if mesh is None else mesh.take
    ranks = 1 if mesh is None else mesh.dp
    if z is None:
        shape = (triplets.shape[0] * ranks, noise_dim)
        if isinstance(generator, RngStream):
            z = generator.normal("kg_train", shape)
        elif generator is not None:
            z = torch.randn(shape, generator=generator, device=generator.device)
        else:
            raise ValueError("kg_train_step needs a generator or z")
    if mesh is not None:
        b = triplets.shape[0]
        if z.shape[0] != b * ranks:
            raise ValueError(f"z has {z.shape[0]} rows; the global batch {b} x {ranks} "
                             "data ranks")
        z = z[mesh.data_rank * b:(mesh.data_rank + 1) * b]
    z = z.to(device=device, dtype=torch.float32)
    h_idx, r_idx, t_idx = triplets[:, 0], triplets[:, 1], triplets[:, 2]

    # --- D step (tables frozen) ---
    d_req = _trainable(state.d_params)
    h, r, t = take(state.node_emb, h_idx), state.rel_emb[r_idx], take(state.node_emb, t_idx)
    with torch.no_grad():
        fake_t = kg_gan.generator_apply(state.g_params, h, r, z)
    real_logits = kg_gan.discriminator_apply(d_req, h, r, t)
    fake_logits = kg_gan.discriminator_apply(d_req, h, r, fake_t)
    neg_terms = [F.softplus(fake_logits).mean()]
    if negatives is not None:
        t_neg = take(state.node_emb, negatives[:, 0])
        r_neg = state.rel_emb[negatives[:, 1]]
        neg_terms.append(F.softplus(kg_gan.discriminator_apply(d_req, h, r, t_neg)).mean())
        neg_terms.append(F.softplus(kg_gan.discriminator_apply(d_req, h, r_neg, t)).mean())
    d_loss = F.softplus(-real_logits).mean() + torch.stack(neg_terms).mean()
    d_grads = _grads(d_loss, d_req)
    d_values = (d_loss.detach(), real_logits.mean().detach(), fake_logits.mean().detach())
    if ranks > 1:
        d_grads, d_values = _mean_over_ranks(mesh.data, d_grads, d_values)
    d_params, d_opt = adam_update(opt, state.d_params, d_grads, state.d_opt)

    # --- G + tables step ---
    g_and_tables = (state.g_params, state.node_emb, state.rel_emb)
    g_req, node_emb, rel_emb = req = _trainable(g_and_tables)
    h, r, t = take(node_emb, h_idx), rel_emb[r_idx], take(node_emb, t_idx)
    fake_t = kg_gan.generator_apply(g_req, h, r, z)
    adv = F.softplus(-kg_gan.discriminator_apply(d_params, h, r, fake_t)).mean()
    cos = rank_ops.cosine_similarity(fake_t, t).mean()
    if ce_negatives is not None:
        ce = _sampled_rank_ce(fake_t, node_emb, t_idx, ce_negatives, take)
    elif mesh is None:
        ce = _rank_ce(fake_t, node_emb, t_idx)
    else:
        ce = mesh.rank_ce(fake_t, node_emb, t_idx, _CE_TEMPERATURE)
    # adv is down-weighted by default: the ranking cross-entropy is the
    # quality-bearing objective.
    g_loss = adv_weight * adv - cosine_weight * cos + ce_weight * ce
    g_grads = _grads(g_loss, req)
    g_values = (g_loss.detach(), cos.detach())
    if ranks > 1:
        g_grads, g_values = _mean_over_ranks(mesh.data, g_grads, g_values)
    (g_params, node_emb, rel_emb), g_opt = adam_update(opt, g_and_tables, g_grads, state.g_opt)

    metrics = {"d_loss": d_values[0], "g_loss": g_values[0], "real_logit": d_values[1],
               "fake_logit": d_values[2], "gen_cosine": g_values[1]}
    return KGTrainState(node_emb, rel_emb, g_params, d_params, g_opt, d_opt), metrics


@torch.no_grad()
def kg_eval_hits(g_params, node_emb, rel_emb, triplets, z, k: int = 10,
                 mesh=None) -> torch.Tensor:
    """Hit@k of the true tail under generator cosine ranking.
    Rank = 1 + #entities scoring strictly higher than the true tail.

    ``mesh`` (the run's ``parallel/sharded_kg.py:KGMesh``): ``node_emb`` is
    this rank's row shard (``parallel/dp_train.py:shard_kg_state``),
    ``triplets`` and ``z`` this rank's rows of the batch along "data", in
    any share. Each rank counts the entities above the true tail in its
    valid rows, the counts are summed over "model" and the hits and rows
    over "data": the whole batch's Hit@k, on every rank."""
    if mesh is not None:
        mesh.require_shard(node_emb)
    take = _take if mesh is None else mesh.take
    h = take(node_emb, triplets[:, 0])
    r = rel_emb[triplets[:, 1]]
    pred = kg_gan.generator_apply(g_params, h, r, z)
    if mesh is not None:
        above = mesh.count_above(pred, node_emb, triplets[:, 2])
        counts = torch.stack([(above < k).sum(), torch.tensor(len(triplets), device=pred.device)])
        dist.all_reduce(counts, group=mesh.data)
        return counts[0].float() / counts[1].float()
    sims = rank_ops.cosine_scores(rank_ops.l2_normalize(pred),
                                  rank_ops.l2_normalize(node_emb))  # [B, N]
    true_sim = sims.gather(1, triplets[:, 2:3])
    rank = 1 + (sims > true_sim).sum(dim=1)
    return (rank <= k).float().mean()
