"""EM-LLM on a HuggingFace causal LM (port of
``hebo_tpu/emllm/hf_integration.py``).

Chunked prefill, surprise segmentation from the model's own token
log-probabilities, per-layer KV events kept out of the window, and
two-stage (similarity + contiguity) retrieval back into it, as EM-LLM
streams long contexts.  The runner drives any HF causal LM through the
public ``past_key_values`` interface: the retrieved events' KV become the
past-KV prefix of the next chunk, which is the same injection point as
patching attention (keys and values prepended to the window).

The model, its inputs and the episodic memories live on ``device``
(``"cuda"`` by default).  ``transformers`` is imported only where a cache
object is built, so the module imports without it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .memory import EpisodicKVMemory
from .segmentation import segment_events

__all__ = ["EMLLMRunner"]


class EMLLMRunner:
    """Chunked long-context inference with episodic KV retrieval.

    Args:
        model: a HF causal LM (e.g. ``GPT2LMHeadModel``); it is moved to
            ``device`` and set to eval mode.
        chunk_size: prefill chunk length (the local attention window).
        n_retrieve: events retrieved per chunk (similarity stage).
        n_contig: temporal neighbours added per retrieved event.
        event_len: max stored event length.
    """

    def __init__(self, model, chunk_size: int = 64, n_retrieve: int = 2, n_contig: int = 1,
                 event_len: int = 32, surprise_gamma: float = 1.0, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.config
        self.n_layers = int(self.cfg.num_hidden_layers)
        self.n_heads = int(getattr(self.cfg, "num_attention_heads", getattr(self.cfg, "n_head", 1)))
        self.chunk_size = chunk_size
        self.n_retrieve = n_retrieve
        self.n_contig = n_contig
        self.surprise_gamma = surprise_gamma
        self.event_len = event_len
        self.reset()
        # retrieval proxy: memory keys are scored with the model's own
        # per-layer attention queries (GPT-2-like module layout), else with
        # the chunk's mean input embedding
        self._gpt2_blocks = getattr(getattr(model, "transformer", None), "h", None)

    def reset(self):
        """Drop all episodic memory (fresh stream)."""
        self.memories = [EpisodicKVMemory(event_len=self.event_len, device=self.device)
                         for _ in range(self.n_layers)]

    def _long(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.long, device=self.device)

    # ------------------------------------------------------------ internal
    def _retrieve_past(self, q_proxy: torch.Tensor):
        """A past_key_values prefix from the retrieved events, each layer's
        KV left-padded with zeros to the longest; (None, 0) when nothing is
        retrieved.  ``q_proxy``: (L, T, H, Dh) per-layer queries or an
        (H, Dh) proxy shared by the layers."""
        past = []
        total = 0
        per_layer = q_proxy.ndim >= 3
        for li, mem in enumerate(self.memories):
            if len(mem) == 0:
                past.append(None)
                continue
            qp = q_proxy[li] if per_layer else q_proxy
            ids = mem.retrieve(qp if qp.ndim == 3 else qp[None], k_sim=self.n_retrieve,
                               k_contig=self.n_contig, mode="full")
            got = mem.gather_kv(ids)
            if got is None:
                past.append(None)
                continue
            K, V, m = got  # (Lr, H, Dh) and the padded rows' validity
            K, V = K[m], V[m]
            total = max(total, K.shape[0])
            past.append((K.float().permute(1, 0, 2)[None], V.float().permute(1, 0, 2)[None]))
        if all(p is None for p in past):
            return None, 0
        Dh = next(p for p in past if p is not None)[0].shape[-1]
        out = []
        for p in past:
            k, v = p if p is not None else (torch.zeros((1, self.n_heads, 0, Dh), device=self.device),) * 2
            if k.shape[2] < total:
                pad = torch.zeros((1, self.n_heads, total - k.shape[2], Dh), device=self.device)
                k, v = torch.cat([pad, k], dim=2), torch.cat([pad, v], dim=2)
            out.append((k, v))
        return out, total

    def _to_cache(self, past):
        """Wrap legacy (k, v) tuples for modern transformers versions."""
        if past is None:
            return None
        try:
            from transformers import DynamicCache

            return DynamicCache.from_legacy_cache(tuple(past))
        except Exception:
            return tuple(past)

    def _chunk_proxy(self, x: torch.Tensor) -> torch.Tensor:
        """Similarity proxy for a chunk.  GPT-2-like models: a preliminary
        no-cache forward gives the hidden states and each block's
        ``c_attn`` projects them to that layer's attention queries, so
        memory keys are scored in the space attention uses: (L, T, H, Dh).
        Otherwise the chunk's mean input embedding, (H, Dh)."""
        with torch.no_grad():
            if self._gpt2_blocks is None:
                emb = self.model.get_input_embeddings()(x)[0]
                return emb.mean(0).reshape(self.n_heads, emb.shape[-1] // self.n_heads)
            hs = self.model(x, output_hidden_states=True, use_cache=False).hidden_states
            proxies = []
            for li, block in enumerate(self._gpt2_blocks):
                qkv = block.attn.c_attn(block.ln_1(hs[li]))  # (1, T, 3D)
                D = qkv.shape[-1] // 3
                proxies.append(qkv[0, :, :D].reshape(-1, self.n_heads, D // self.n_heads))
        return torch.stack(proxies)

    # -------------------------------------------------------------- public
    def process(self, input_ids) -> dict:
        """Stream a long token sequence through the model.

        Returns the per-token negative log-likelihoods (host numpy), the
        events stored and the tokens retrieved per chunk."""
        ids = np.asarray(input_ids).ravel()
        nlls: List[np.ndarray] = []
        retrieved_hist: List[int] = []
        with torch.no_grad():
            for s in range(0, len(ids), self.chunk_size):
                chunk = ids[s : s + self.chunk_size]
                x = self._long(chunk[None])
                past, n_past = self._retrieve_past(self._chunk_proxy(x))
                retrieved_hist.append(n_past)
                # positions restart at 0 every chunk: the retrieved prefix
                # carries no positional coherence, and past-offset positions
                # would leave the model's trained range
                out = self.model(x, past_key_values=self._to_cache(past),
                                 attention_mask=torch.ones((1, n_past + len(chunk)), dtype=torch.long,
                                                           device=self.device),
                                 position_ids=torch.arange(len(chunk), device=self.device)[None],
                                 use_cache=True)
                logp = torch.log_softmax(out.logits[0][:-1], dim=-1)
                tgt = x[0, 1:]
                nll = -logp[torch.arange(len(tgt), device=self.device), tgt]
                nll_host = nll.cpu().numpy()
                nlls.append(nll_host)
                # surprise for segmentation: the first token gets the mean
                surprise = np.concatenate([[float(nll.mean())] if len(nll) else [0.0], nll_host])[: len(chunk)]
                # store this chunk's fresh KV (the retrieved prefix stripped);
                # boundaries are refined on layer 0's keys
                pkv = out.past_key_values
                spans = None
                for li in range(self.n_layers):
                    Kc = pkv[li][0][0, :, n_past:, :].permute(1, 0, 2)
                    Vc = pkv[li][1][0, :, n_past:, :].permute(1, 0, 2)
                    if spans is None:
                        spans = segment_events(Kc.reshape(Kc.shape[0], -1), surprise,
                                               gamma=self.surprise_gamma, min_event=4)
                    self.memories[li].add_events(Kc, Vc, spans)
        return {"nll_per_token": np.concatenate(nlls + [np.zeros(0)]).astype(np.float64),
                "n_events": len(self.memories[0]), "retrieved_per_chunk": retrieved_hist}

    def generate(self, query_ids, n_new: int = 3, pos0: Optional[int] = None) -> List[int]:
        """Greedy-decode ``n_new`` tokens after ``query_ids``, attending over
        the episodic memory built by earlier ``process`` calls.  ``pos0``
        places the query tokens where the model expects queries."""
        q = np.asarray(query_ids).ravel()
        p0 = 0 if pos0 is None else int(pos0)
        with torch.no_grad():
            x = self._long(q[None])
            past, n_past = self._retrieve_past(self._chunk_proxy(x))
            total = n_past + len(q)
            out = self.model(x, past_key_values=self._to_cache(past),
                             attention_mask=torch.ones((1, total), dtype=torch.long, device=self.device),
                             position_ids=(p0 + torch.arange(len(q), device=self.device))[None],
                             use_cache=True)
            toks: List[int] = []
            for i in range(n_new):
                t = int(out.logits[0, -1].argmax())
                toks.append(t)
                total += 1
                out = self.model(self._long([[t]]), past_key_values=out.past_key_values,
                                 attention_mask=torch.ones((1, total), dtype=torch.long, device=self.device),
                                 position_ids=self._long([[p0 + len(q) + i]]), use_cache=True)
        return toks
