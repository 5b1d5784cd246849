"""Token-level language model + sampling + generation server.

The reference framework stops at the activations level — its transformer
demo feeds random hidden states (``tests/transformer/driver.py:21-24``)
and has no vocabulary, sampling, or generation loop. A deployment needs
the token boundary, so this module closes it:

  * ``SparseLM`` — embedding + ``SparseTransformer`` core + final
    LayerNorm + (tied or separate) LM head: ``tokens [b, s] ->
    logits [b, s, vocab]``.
  * ``sample_logits`` — on-device sampling: temperature, top-k, top-p
    (nucleus), greedy.  Static-shape, jit-safe.
  * ``LMServer`` — token-in/token-out generation over the block-KV
    ``SparseDecoder`` runtime: one jittable ``generate`` (prefill +
    ``lax.scan`` decode + in-loop sampling).

Everything downstream (GQA caches, int8/bf16 KV, sliding window + sinks,
tensor-parallel serving) comes from the wrapped ``SparseDecoder``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .module import Dense, Embed, LayerNorm, Module, layernorm
from .serving import SparseDecoder
from .transformer import SparseTransformer

__all__ = ["SparseLM", "LMServer", "sample_logits",
           "apply_repetition_penalty"]


@dataclasses.dataclass(frozen=True)
class SparseLM(Module):
    """Sparse-attention language model: ``tokens [b, s] -> logits
    [b, s, vocab]``.

    ``core`` carries the mask topology and all transformer hyperparams;
    ``tie_embeddings=True`` (default) reuses the embedding matrix as the
    LM head (``logits = x @ E^T``), the standard memory-saving tie.
    A final LayerNorm (``ln_f``) precedes the head — the core's blocks
    are pre-LN, so the last residual stream is unnormalised without it.
    """

    core: SparseTransformer
    vocab_size: int
    tie_embeddings: bool = True
    final_layernorm: bool = True

    @classmethod
    def from_masks(cls, masks: np.ndarray, *, vocab_size: int,
                   tie_embeddings: bool = True, final_layernorm: bool = True,
                   **core_kwargs) -> "SparseLM":
        """Build with per-batch dense 0/1 masks ``[b, s, s]``; extra
        kwargs go to ``SparseTransformer`` (num_layers, hidden_size, ...)."""
        return cls(core=SparseTransformer.from_masks(masks, **core_kwargs),
                   vocab_size=vocab_size, tie_embeddings=tie_embeddings,
                   final_layernorm=final_layernorm)

    def forward(self, scope, tokens):
        embed = Embed(num_embeddings=self.vocab_size,
                      features=self.core.hidden_size)
        x = embed(scope.child("embed"), tokens)
        x = self.core(scope.child("core"), x)
        if self.final_layernorm:
            x = LayerNorm(epsilon=1e-6)(scope.child("ln_f"), x)
        if self.tie_embeddings:
            return embed.attend(scope.child("embed"), x)
        return Dense(self.vocab_size, use_bias=False)(
            scope.child("lm_head"), x)


def apply_repetition_penalty(logits, present, penalty: float):
    """HF-style repetition penalty: for tokens marked ``present``
    (bool ``[..., vocab]``), positive logits divide by ``penalty`` and
    negative logits multiply — both push already-seen tokens down."""
    pen = jnp.where(logits > 0, logits / penalty, logits * penalty)
    return jnp.where(present, pen, logits)


def sample_logits(key, logits, *, temperature: float = 1.0,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None):
    """Sample token ids from ``logits [..., vocab]``.

    ``temperature == 0`` is greedy (argmax; ``key`` unused). ``top_k``
    keeps the k largest logits; ``top_p`` keeps the smallest prefix of
    the sorted distribution with cumulative probability >= ``top_p``
    (nucleus sampling). Standard serving order (HF/vLLM): temperature
    scales FIRST, then top-k, then top-p — so the nucleus mass test
    runs on the distribution actually sampled. All branches are static
    Python — the traced graph contains only the selected filter, so
    this is jit-safe with static sampling params. (Repetition penalty
    composes BEFORE this function — ``apply_repetition_penalty`` with a
    token-presence mask, as ``LMServer.generate`` does.)
    """
    if temperature == 0.0:
        return jnp.argmax(logits, axis=-1)
    logits = logits / temperature
    neg_inf = jnp.asarray(-1e30, logits.dtype)
    if top_k is not None and top_k < logits.shape[-1]:
        kth = jax.lax.top_k(logits, top_k)[0][..., -1:]
        logits = jnp.where(logits < kth, neg_inf, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = jnp.sort(logits, axis=-1)[..., ::-1]
        probs = jax.nn.softmax(sorted_logits, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        # keep a token if the mass BEFORE it is < top_p (the first token
        # is always kept); threshold = smallest kept sorted logit
        keep = (cum - probs) < top_p
        thresh = jnp.min(jnp.where(keep, sorted_logits, jnp.inf),
                         axis=-1, keepdims=True)
        logits = jnp.where(logits < thresh, neg_inf, logits)
    return jax.random.categorical(key, logits, axis=-1)


class LMServer:
    """Token-level generation runtime over a ``SparseLM``.

    Wraps a ``SparseDecoder`` bound to the LM's transformer core; the
    embedding / final-LN / head params are applied by hand around the
    decoder's activation-level steps so the whole generate loop jits as
    one program. All ``SparseDecoder`` serving options pass through
    (``window``/``sinks``, ``cache_dtype`` incl. int8 KV, GQA via the
    core's ``num_kv_heads``).

    ``prompt`` length must equal the core mask's row count (the prefill
    attention runs the model's own sparse topology, exactly like
    training); decode attends full-causal or sinks+window over the
    block-KV cache.
    """

    def __init__(self, lm: SparseLM, *, s_max: Optional[int] = None,
                 bk: int = 256,
                 window: Optional[int] = None, sinks: int = 0,
                 cache_dtype=jnp.bfloat16, n_pages: Optional[int] = None,
                 decoder: Optional[SparseDecoder] = None):
        self.lm = lm
        if decoder is not None:
            # externally-built runtime (tensor-parallel serving wraps the
            # PER-SHARD decoder here and runs generate inside shard_map)
            self.decoder = decoder
            return
        if s_max is None:
            raise ValueError("s_max is required (unless decoder= is given)")
        if n_pages is not None:
            # paged serving (ops/paged.py): KV in a shared page pool.
            # generate() reserves its decode pages up front (a HOST
            # scheduler step), so do NOT wrap generate in an outer
            # jax.jit with a paged server — the inner scan still jits.
            from .serving_paged import PagedDecoder

            self.decoder = PagedDecoder(
                lm.core, n_pages=n_pages, s_max=s_max, bk=bk,
                window=window, sinks=sinks, cache_dtype=cache_dtype)
        else:
            self.decoder = SparseDecoder(
                lm.core, s_max=s_max, bk=bk, window=window, sinks=sinks,
                cache_dtype=cache_dtype)

    # -- params plumbing ---------------------------------------------------

    @staticmethod
    def _split(params):
        p = params.get("params", params)
        return p, {"params": p["core"]}

    def _head(self, p, x):
        """final LayerNorm + LM head on activations ``x [b, s, h]``."""
        if self.lm.final_layernorm:
            x = layernorm(p["ln_f"], x)
        if self.lm.tie_embeddings:
            emb = p["embed"]["embedding"]
            return x @ emb.T.astype(x.dtype)
        return x @ p["lm_head"]["kernel"]

    def _embed(self, p, tokens):
        return jnp.take(p["embed"]["embedding"], tokens, axis=0)

    # -- generation ----------------------------------------------------------

    def init_caches(self, batch: int):
        return self.decoder.init_caches(batch)

    def prefill(self, params, tokens, caches, reduce_fn=None,
                lengths=None):
        """Prompt pass: ``tokens [b, P] -> (logits [b, P, vocab], caches)``.
        ``lengths``: per-sequence prompt lengths for right-padded
        variable-length batches (positions past a sequence's length hold
        garbage logits — read row ``s`` at ``lengths[s] - 1``)."""
        p, core_params = self._split(params)
        y, caches = self.decoder.prefill(core_params, self._embed(p, tokens),
                                         caches, reduce_fn=reduce_fn,
                                         lengths=lengths)
        return self._head(p, y), caches

    def decode_step(self, params, tok, caches, reduce_fn=None):
        """One token: ``tok [b] -> (logits [b, vocab], caches)``."""
        p, core_params = self._split(params)
        x = self._embed(p, tok)[:, None, :]
        y, caches = self.decoder.decode_step(core_params, x, caches,
                                             reduce_fn=reduce_fn)
        return self._head(p, y)[:, 0], caches

    def decode_step_ragged(self, params, tok, caches, active=None,
                           reduce_fn=None):
        """Token-level continuous-batching step: sequences at different
        cache positions, ``active`` freezing finished slots — see
        ``SparseDecoder.decode_step_ragged`` for semantics and the
        scatter-append cost note, ``ops.decode.insert_kv_slot`` for
        admitting a new request into a retired slot (the caches here ARE
        the core decoder's caches, so cache-level admission applies
        unchanged). ``tok [b] -> (logits [b, vocab], caches)``."""
        p, core_params = self._split(params)
        x = self._embed(p, tok)[:, None, :]
        y, caches = self.decoder.decode_step_ragged(
            core_params, x, caches, active, reduce_fn=reduce_fn)
        return self._head(p, y)[:, 0], caches

    def generate(self, params, tokens, n_new: int, key=None, *,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 repetition_penalty: float = 1.0,
                 prompt_lengths=None, reduce_fn=None, caches=None):
        """Generate ``n_new`` tokens after prompt ``tokens [b, P]``.

        Returns ``(new_tokens [b, n_new], caches)``. Sampling params are
        static. ``key`` is required unless greedy.

        Eager calls run ONE jit dispatch: page reservation (a host
        scheduler step, paged servers) happens up front, then the whole
        prefill + decode scan runs through a memoized jitted core —
        an eager serving loop previously re-traced the program every
        call (~seconds of host Python at 6L/h=1024). Called inside an
        existing trace (the tensor-parallel wrapper's shard_map, or a
        user jit), the body inlines as before — pre-reserve the pages
        yourself then (``caches=``), as ``TPLMServer`` does.

        ``eos_id``: sequences that emit it are finished — every later
        position holds ``pad_id`` (the standard uniform-batch behaviour:
        the loop still runs to ``n_new`` at full batch width; a
        multi-tenant deployment that wants to REUSE finished slots runs
        the ragged path, ``SparseDecoder.decode_step_ragged`` +
        ``ops.decode.insert_kv_slot``, instead).

        ``prompt_lengths`` (i32 ``[b]``): per-sequence lengths for a
        variable-length batch right-padded to ``P``. Each sequence's
        first token samples from its own last REAL position and decode
        runs the ragged step (per-slot cache positions) — no padding of
        the generation to the longest prompt.

        ``repetition_penalty`` (HF semantics, > 1 discourages repeats):
        logits of every token already present in the sequence (prompt +
        generated so far) are penalised before sampling; applies to
        greedy decoding too.
        """
        if n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {n_new}")
        if temperature != 0.0 and key is None:
            raise ValueError("sampling (temperature != 0) needs a PRNG key")
        key = key if key is not None else jax.random.PRNGKey(0)

        from ..ops import _common

        paged = hasattr(self.decoder, "reserve")
        ext_caches = caches is not None
        if caches is None:
            caches = self.init_caches(tokens.shape[0])
        if paged and _common.trace_clean():
            # paged pool: prompt + decode pages in ONE host reservation,
            # before any trace. Runs for USER-PASSED caches too —
            # ensure_pages is idempotent (fills only holes), and inside
            # the jitted core the prefill CANNOT reserve (it sees
            # tracers), so skipping here would scatter the prompt to the
            # dump page and decode silently wrong tokens.
            caches = self.decoder.reserve(caches, tokens.shape[1] + n_new)
        elif paged and not ext_caches:
            # in-trace paged generate with no caller-prepared caches:
            # page reservation is host-only — fail loudly (the old eager
            # API raised ConcretizationTypeError here; silence would be
            # dump-page corruption)
            raise ValueError(
                "paged generate inside a trace needs pre-reserved "
                "caches= (reserve(init_caches(b), P + n_new) on the "
                "host first, as TPLMServer does)")

        statics = (n_new, temperature, top_k, top_p, eos_id, pad_id,
                   repetition_penalty, prompt_lengths is None,
                   jax.tree.structure(tuple(caches)))
        if reduce_fn is None and _common.trace_clean():
            jits = getattr(self, "_gen_jits", None)
            if jits is None:
                jits = self._gen_jits = {}
            fn = jits.get(statics)
            if fn is None:
                def run(p, t, c, k2, pl):
                    return self._generate_impl(
                        p, t, n_new, k2, temperature=temperature,
                        top_k=top_k, top_p=top_p, eos_id=eos_id,
                        pad_id=pad_id,
                        repetition_penalty=repetition_penalty,
                        prompt_lengths=pl, reduce_fn=None, caches=c)

                fn = jax.jit(run, static_argnums=())
                jits[statics] = fn
                while len(jits) > 16:
                    jits.pop(next(iter(jits)))
            return fn(params, tokens, tuple(caches), key, prompt_lengths)
        return self._generate_impl(
            params, tokens, n_new, key, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_id=eos_id, pad_id=pad_id,
            repetition_penalty=repetition_penalty,
            prompt_lengths=prompt_lengths, reduce_fn=reduce_fn,
            caches=tuple(caches))

    def _generate_impl(self, params, tokens, n_new, key, *, temperature,
                       top_k, top_p, eos_id, pad_id, repetition_penalty,
                       prompt_lengths, reduce_fn, caches):
        b = tokens.shape[0]
        if repetition_penalty != 1.0:
            # token-presence mask [b, vocab], seeded from the prompt
            # (pad positions excluded when prompt_lengths is given)
            valid = jnp.ones(tokens.shape, bool) if prompt_lengths is None \
                else (jnp.arange(tokens.shape[1])[None, :]
                      < jnp.asarray(prompt_lengths, jnp.int32)[:, None])
            present0 = jnp.zeros((b, self.lm.vocab_size), bool).at[
                jnp.arange(b)[:, None], tokens].max(valid)
        else:
            present0 = None

        def pick(k, logits, done, present):
            if present is not None:
                logits = apply_repetition_penalty(
                    logits, present, repetition_penalty)
            tok = sample_logits(k, logits, temperature=temperature,
                                top_k=top_k, top_p=top_p)
            if eos_id is not None:
                tok = jnp.where(done, pad_id, tok)
                done = done | (tok == eos_id)
            if present is not None:
                present = present.at[jnp.arange(b), tok].set(True)
            return tok, done, present

        # prefill at the activation level and head ONLY the last position
        # (self.prefill scores all P positions — a [b, P, vocab] logits
        # tensor nobody reads here, ~GBs at long prompts / big vocabs).
        # ``caches`` arrive prepared: pages (paged pools) were reserved
        # by generate()'s host phase, or by the caller (the tensor-
        # parallel wrapper) — no host scheduling happens in here, so the
        # whole body traces.
        p, core_params = self._split(params)
        y, caches = self.decoder.prefill(
            core_params, self._embed(p, tokens),
            caches, reduce_fn=reduce_fn,
            lengths=prompt_lengths)
        if prompt_lengths is None:
            last = y[:, -1:]
            step = self.decode_step
        else:
            idx = (jnp.asarray(prompt_lengths, jnp.int32) - 1)[:, None,
                                                               None]
            last = jnp.take_along_axis(
                y, jnp.broadcast_to(idx, (y.shape[0], 1, y.shape[2])),
                axis=1)
            step = self.decode_step_ragged  # per-slot cache positions
        key, sub = jax.random.split(key)
        done0 = jnp.zeros((b,), bool)
        tok, done, present = pick(sub, self._head(p, last)[:, 0], done0,
                                  present0)

        def body(carry, _):
            tok, done, present, caches, key = carry
            logits, caches = step(params, tok, caches,
                                  reduce_fn=reduce_fn)
            key, sub = jax.random.split(key)
            nxt, done, present = pick(sub, logits, done, present)
            return (nxt, done, present, caches, key), tok

        (last, _, _, caches, _), toks = jax.lax.scan(
            body, (tok, done, present, tuple(caches), key), None,
            length=n_new - 1)
        # toks [n_new-1, b] (empty when n_new == 1) + the final carry
        new_tokens = jnp.concatenate(
            [jnp.moveaxis(toks, 0, 1), last[:, None]], axis=1)
        return new_tokens, caches
