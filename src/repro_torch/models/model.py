"""Public model API: build(cfg, device) -> LM with init / loss / prefill /
decode.

Counterpart of ``repro.models.model``: ``train_loss`` and ``logits`` (the
training path, :func:`repro_torch.models.transformer.stack_train`,
differentiable, never under ``no_grad``), ``prefill`` and ``decode_step``
(serving, under ``no_grad``). Parameters are a plain nested
dict of tensors with the reference's tree: ``embed (C,V,D)``,
``stack.layers.*`` stacked ``(L, ...)``, ``final_norm.w`` (and ``.b``
under LayerNorm), ``head (C,D,V)`` when the embeddings are not tied, where
``C = max(n_codebooks, 1)``; the hybrid stack adds ``stack.shared.*``
(one attention block), ``stack.lora_a`` and ``stack.lora_b``. The decode
cache is an attention stack's stacked K/V (``{"k", "v"}``,
``(L,B,S,KV,dh)``), the rwkv6 stack's recurrent carry (``{"ssm": {"att_x",
"ffn_x", "state"}}``, no seq axis) or the hybrid stack's both
(``{"ssm": {"conv", "ssm"}, "k", "v"}``, K/V one slab a shared-block
invocation).

Batch dict convention (fields past ``tokens`` optional):
  tokens       (B,S) int64               [(B,S,C) for codebooks]
  labels       same shape as tokens      (train_loss)
  loss_mask    (B,S), optional           (train_loss)
  positions    (B,S) int, or (B,S,3) for M-RoPE; defaults to arange
  patch_embeds (B,Np,D)                  vision stub: patch embeddings
  patch_mask   (B,S) bool                True where a slot is a patch
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import require_device
from repro_torch.launch import sharding as shardlib
from .layers import apply_norm, dense
from .loss import mean_xent
from .transformer import (
    empty_cache,
    init_stack,
    stack_decode,
    stack_prefill,
    stack_train,
)


def _dt(name):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


@dataclass(frozen=True)
class LM:
    cfg: ModelConfig
    device: torch.device

    # ------------------------------------------------------------- params --
    def init(self, seed_or_generator: int | torch.Generator = 0,
             shardings=None) -> dict:
        """Random parameters on ``self.device``: embed normal * d^-0.5,
        linears uniform(+-fan_in^-0.5), unit norms, zero biases; one
        embedding table and one head a codebook. Each leaf is allocated
        once, so the peak memory of a call is the parameters' bytes and
        one layer's leaf at most. On the ``meta`` device the tree holds
        shapes and dtypes alone (the sharding specs' input).

        ``shardings``: a tree of this rank's
        :class:`~repro_torch.launch.specs.Sharding`s for the parameters
        (:func:`repro_torch.launch.train.placement`). Each leaf (a stacked
        one a layer at a time) is drawn whole, in the unsplit order, and
        cut to this rank's slice at once: the unsplit tree's values
        sliced, at a peak of this rank's shards and one whole leaf of a
        layer (or the embedding, or the head)."""
        cfg = self.cfg
        gen = seed_or_generator
        if self.device.type == "meta":
            gen = None                  # shapes and dtypes only: no draws
        elif not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(gen))

        def cut(name, whole):
            if shardings is None:
                return whole
            return shardings[name].local(whole).clone()

        pdt = _dt(cfg.param_dtype)
        n_emb = max(cfg.n_codebooks, 1)
        params: dict[str, Any] = {}
        params["embed"] = cut("embed", torch.randn(
            (n_emb, cfg.vocab_size, cfg.d_model), generator=gen, dtype=pdt,
            device=self.device).mul_(cfg.d_model ** -0.5))
        params["stack"] = init_stack(
            gen, cfg, pdt, self.device,
            None if shardings is None else shardings["stack"])
        norm = {"w": torch.ones((cfg.d_model,), dtype=pdt,
                                device=self.device)}
        if cfg.norm == "layernorm":
            norm["b"] = torch.zeros((cfg.d_model,), dtype=pdt,
                                    device=self.device)
        params["final_norm"] = {k: v if shardings is None else
                                shardings["final_norm"][k].local(v).clone()
                                for k, v in norm.items()}
        if not cfg.tie_embeddings:
            lim = cfg.d_model ** -0.5
            params["head"] = cut("head", torch.rand(
                (n_emb, cfg.d_model, cfg.vocab_size), generator=gen,
                dtype=pdt, device=self.device).mul_(2).sub_(1).mul_(lim))
        return params

    # -------------------------------------------------------------- embed --
    def _embed(self, params, batch):
        """Token embeddings in the activation dtype, in the reference's
        order: the codebooks' embeddings summed (``c = 0..C-1`` in turn,
        as Python's ``sum`` adds them), the vision stub's patch
        embeddings merged, then the sinusoidal table added.

        The merge is position-aligned, as the reference's ``where``: patch
        ``s`` lands at slot ``s`` where ``patch_mask`` is set there, and
        slots past the patches take zeros where the mask is set. The
        sinusoidal table is ``concat(sin, cos)`` over ``d_model/2``
        frequencies of the positions, in float32, cast before it is
        added.

        Sequence parallelism (:meth:`_seq`): the output is this model
        rank's slice of the sequence — the vocabulary-parallel lookup's
        partial sums reduce-scattered to it, a whole table's lookup cut
        to it, the patches and the sinusoidal table taken at its rows."""
        cfg = self.cfg
        adt = _dt(cfg.dtype)
        tokens = batch["tokens"]
        emb = shardlib.whole(params["embed"])
        seq = self._seq(tokens.shape[1])
        split = emb.shape[1] < cfg.vocab_size
        if split:
            # this rank's vocabulary rows: look up the tokens inside them,
            # zeros elsewhere, and add over the model ranks
            v_loc = emb.shape[1]
            local = tokens - shardlib.rank_in("vocab") * v_loc
            inside = ((local >= 0) & (local < v_loc))[..., None]
            tokens = local.clamp(0, v_loc - 1)

            def look(c, t):
                e = emb[c][t].to(adt)
                return torch.where(inside if t.ndim == tokens.ndim
                                   else inside[..., c, :], e,
                                   torch.zeros_like(e))
        else:
            def look(c, t):
                return emb[c][t].to(adt)
        if cfg.n_codebooks:
            x = look(0, tokens[..., 0])
            for c in range(1, cfg.n_codebooks):
                x = x + look(c, tokens[..., c])
        else:
            x = look(0, tokens)
        if split and seq:
            x = shardlib.reduce_scatter_from(x, "vocab", 1)
        elif split:
            x = shardlib.reduce_from(x, "vocab")
        elif seq:
            x = shardlib.scatter_to(x, 1, "seq")
        part = shardlib.seq_part if seq else (lambda t: t)
        if cfg.vision_stub and "patch_embeds" in batch:
            B, S, D = batch["patch_mask"].shape + (x.shape[-1],)
            pe = batch["patch_embeds"].to(adt)
            pe_full = torch.cat([pe, pe.new_zeros((B, S - pe.shape[1], D))],
                                dim=1)
            x = torch.where(part(batch["patch_mask"])[..., None],
                            part(pe_full), x)
        if cfg.pos_emb == "sin":
            pos = batch.get("positions")
            if pos is None:
                pos = torch.arange(tokens.shape[1], device=x.device)[None]
            pos = part(pos)
            half = cfg.d_model // 2
            inv = 10000.0 ** (-torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half)
            ang = pos.to(torch.float32)[..., None] * inv
            x = x + torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(adt)
        return x

    def _seq(self, S: int) -> bool:
        """Whether a stream of ``S`` tokens runs as the model ranks'
        slices of its sequence (:func:`~repro_torch.launch.sharding.
        seq_split`). The rwkv6 and hybrid stacks, which the reference
        does not annotate, take the whole sequence at their first layer:
        their embedding's output stays whole."""
        return shardlib.seq_split(S) and self.cfg.family not in ("ssm",
                                                                "hybrid")

    def _positions(self, batch, S, offset=0):
        pos = batch.get("positions")
        if pos is None:
            B = batch["tokens"].shape[0]
            pos = (torch.arange(S, device=self.device)[None] + offset
                   ).expand(B, S)
        return pos

    def _head(self, params, x, S: int | None = None):
        """Logits (B,S,V), or (B,S,C,V) for codebooks: one exact
        ``dense`` a codebook, stacked at axis -2. ``S``: the sequence's
        length, where ``x`` may be this rank's slice of it (sequence
        parallelism): the head gathers the sequence first."""
        cfg = self.cfg
        w = shardlib.whole(params["embed"]).transpose(1, 2) \
            if cfg.tie_embeddings else shardlib.whole(params["head"])
        # a head the placement split over the vocabulary (a tied head
        # takes the embedding's shard) keeps its logits split into the loss
        split = ("col", "vocab") if w.shape[-1] < cfg.vocab_size else None
        kw = {}
        if S is not None and x.shape[1] < S:
            if split:
                split = split + ("seq",)
                kw["full"] = shardlib._gather(x, "vocab", 1)
            else:
                # every rank goes on with the same whole logits
                x = shardlib.all_gather(x, "seq", 1)
        outs = [dense(x, w[c], split=split, **kw)
                for c in range(max(cfg.n_codebooks, 1))]
        return torch.stack(outs, dim=-2) if cfg.n_codebooks else outs[0]

    # --------------------------------------------------------------- loss --
    def train_loss(self, params, batch):
        """Mean token cross-entropy of ``batch["labels"]`` (masked by
        ``batch["loss_mask"]`` when given), averaged over the codebooks,
        plus ``0.01 *`` the summed MoE load-balance losses: a float32
        scalar, differentiable in ``params``. On a bound mesh
        (:mod:`repro_torch.launch.sharding`) ``params`` are this rank's
        shards and ``batch`` its rows: the loss is the whole batch's, and
        the backward carries this rank's share of its gradient (the step
        adds the data ranks')."""
        cfg = self.cfg
        logits, aux = self._forward(params, batch)
        labels, mask = batch["labels"], batch.get("loss_mask")
        V = cfg.vocab_size
        if cfg.n_codebooks:
            loss = mean_xent(logits[..., 0, :], labels[..., 0], mask, V)
            for c in range(1, cfg.n_codebooks):
                loss = loss + mean_xent(logits[..., c, :], labels[..., c],
                                        mask, V)
            loss = loss / cfg.n_codebooks
        else:
            loss = mean_xent(logits, labels, mask, V)
        return loss + 0.01 * aux

    def logits(self, params, batch):
        """Every position's logits (B,S,V) [(B,S,C,V)] through the
        training stack."""
        return self._forward(params, batch)[0]

    def _forward(self, params, batch):
        cfg = self.cfg
        x = self._embed(params, batch)
        S = batch["tokens"].shape[1]
        positions = self._positions(batch, S)
        x, aux = stack_train(params["stack"], x, cfg, positions)
        norm = shardlib.gathered(params["final_norm"])
        if x.shape[1] < S:
            # sequence parallelism: the norm runs on this rank's rows
            norm = shardlib.seq_params(norm)
        x = apply_norm(x, norm, cfg.norm, cfg.norm_eps)
        return self._head(params, x, S), aux

    # -------------------------------------------------------------- serve --
    def empty_cache(self, batch_size: int, max_seq: int):
        return empty_cache(self.cfg, batch_size, max_seq, _dt(self.cfg.dtype),
                           self.device)

    @torch.no_grad()
    def prefill(self, params, batch):
        """Prompt forward pass; returns (last-token logits, decode cache).

        The cache covers exactly the prompt length S; launch/serve.py embeds
        it into a larger cache before decoding continues. On a bound mesh
        the cache is laid out as :meth:`empty_cache` lays it for ``S`` and
        the logits are this rank's shard of the vocabulary where the head
        is split. Nothing here reads
        a tensor on the host, which is what lets the served prefill
        (:func:`repro_torch.launch.serve.make_prefill`) capture this call
        into a CUDA graph per prompt shape; called directly it runs eagerly.
        """
        cfg = self.cfg
        x = self._embed(params, batch)
        S = batch["tokens"].shape[1]
        positions = self._positions(batch, S)
        x, cache = stack_prefill(params["stack"], x, cfg, positions)
        if x.shape[1] < S:
            # sequence parallelism: the last token is the last rank's
            x = shardlib.all_gather(x[:, -1:], "seq", 1)[:, -1:]
        x = apply_norm(x, shardlib.gathered(params["final_norm"]), cfg.norm,
                       cfg.norm_eps)
        return self._head(params, x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos, max_seq=None):
        """tokens: (B,) int64 [(B,C) for codebooks]; pos: the 0-based
        position of the token being decoded — an int, or a (B,) tensor for
        per-row positions. A (B,) tensor on the card is read there and
        never on the host, which is what lets a CUDA graph capture the
        step (:func:`repro_torch.launch.serve.decode_body`); an int is one
        host value the step is built around. Under M-RoPE the position
        drives all three coordinates, as in the reference.

        Returns (logits (B,V) [(B,C,V)], cache): the cache is updated **in
        place** (one token per layer; a recurrent layer's carry
        overwritten in its buffers) and returned.

        On a bound mesh (:mod:`repro_torch.launch.sharding`) ``params`` are
        this rank's shards, ``tokens`` its rows and ``cache`` as
        :meth:`empty_cache` / :meth:`prefill` lay it out on this rank;
        ``max_seq``, the ``max_seq`` the cache was built for, tells a
        cache split by sequence from a whole one (required where the
        model ranks do not divide the kv heads). The logits are this
        rank's shard of the vocabulary where the head is split, as the
        reference's ``shard(logits, "batch", None, "vocab")``. Rows that
        are this rank's share of a batch split over the data ranks are
        declared so by the caller
        (:func:`~repro_torch.launch.sharding.global_batch`): an MoE
        layer's dispatch then takes the whole batch's capacity and slots.
        """
        cfg = self.cfg
        B = tokens.shape[0]
        if torch.is_tensor(pos) and pos.ndim:
            pos = pos.to(self.device)
            positions = pos[:, None]
        else:
            pos = int(pos)
            positions = torch.full((B, 1), pos, device=self.device)
        if cfg.mrope:
            positions = positions[..., None].expand(B, 1, 3)
        x = self._embed(params, {"tokens": tokens[:, None],
                                 "positions": positions})
        x, cache = stack_decode(params["stack"], x, cfg, cache, pos,
                                positions, max_seq)
        x = apply_norm(x, shardlib.gathered(params["final_norm"]), cfg.norm,
                       cfg.norm_eps)
        return self._head(params, x)[:, 0], cache


def build(cfg: ModelConfig, device: torch.device | str = "cuda") -> LM:
    """The LM for ``cfg`` on ``device`` (default: the GPU; raises without
    one unless ``device='cpu'`` is asked for)."""
    return LM(cfg, require_device(device))
