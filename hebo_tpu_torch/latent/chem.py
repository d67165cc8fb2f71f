"""Chem decoder for latent-space molecule BO — SELFIES-style robustness
(port of ``hebo_tpu/latent/chem.py``).

The alphabet, ``MolGraph``, ``decode_tokens``, ``canonical_string``,
``penalized_logp_proxy`` and ``random_molecules`` are the JAX package's
host numpy, copied: every token sequence decodes to a valence-respecting
molecular graph (bond orders clipped to the remaining valence on both
ends, branches on a stack, ring tokens bonding back), serialised
canonically for dedupe and scored by a Crippen-style logP proxy with
ring, fragment and size penalties.

``ChemLatentBO`` runs T-LBO weighted retraining over the GRU sequence VAE
(``latent/decoders.SeqVAE``) on ``device``: rank-weighted ELBO retraining,
GP + EI in the latent box, decode and score.  One deliberate difference:
the JAX package decodes the population one candidate at a time (up to 64
single-row rollouts); the port decodes the whole population in one call,
then walks its rows in the same order with the same dedupe and stop, so
the molecules kept are the same.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..acq_optimizers.evolution import EvolutionOpt
from ..acquisitions.acq import EI, AcqParams
from ..design_space import DesignSpace
from ..models import get_model
from ..optimizers.base import timed
from ..utils.device import resolve_device
from .decoders import SeqVAE, seq_decode, seq_encode, train_seq_vae
from .vae import init_params, rank_weights

__all__ = [
    "ALPHABET",
    "decode_tokens",
    "canonical_string",
    "penalized_logp_proxy",
    "random_molecules",
    "ChemLatentBO",
]

# token alphabet: (kind, element|arg, bond_order)
ALPHABET: List[Tuple[str, str, int]] = [
    ("nop", "", 0),
    ("atom", "C", 1), ("atom", "N", 1), ("atom", "O", 1),
    ("atom", "F", 1), ("atom", "S", 1),
    ("atom", "C", 2), ("atom", "N", 2), ("atom", "O", 2),
    ("atom", "C", 3), ("atom", "N", 3),
    ("branch", "", 0),
    ("pop", "", 0),
    ("ring", "1", 1), ("ring", "2", 1), ("ring", "3", 1),
]
N_TOKENS = len(ALPHABET)
VALENCE = {"C": 4, "N": 3, "O": 2, "F": 1, "S": 2}
# Crippen-inspired additive logP contributions per heavy atom (sign and
# ordering follow the Wildman-Crippen parametrization: carbon lipophilic,
# heteroatoms hydrophilic)
LOGP_CONTRIB = {"C": 0.36, "N": -0.60, "O": -0.64, "F": 0.22, "S": 0.41}


class MolGraph:
    """Atoms (element symbols) + bonds (i, j, order)."""

    def __init__(self):
        self.atoms: List[str] = []
        self.bonds: List[Tuple[int, int, int]] = []

    def free_valence(self, i: int) -> int:
        used = sum(o for a, b, o in self.bonds if a == i or b == i)
        return VALENCE[self.atoms[i]] - used

    def add_atom(self, el: str) -> int:
        self.atoms.append(el)
        return len(self.atoms) - 1

    def add_bond(self, i: int, j: int, order: int) -> bool:
        if i == j:
            return False
        if any((a, b) in ((i, j), (j, i)) for a, b, _ in self.bonds):
            return False
        o = min(order, self.free_valence(i), self.free_valence(j))
        if o <= 0:
            return False
        self.bonds.append((i, j, o))
        return True


def decode_tokens(tokens) -> MolGraph:
    """Derivation-rule decode: ANY token sequence yields a valid graph."""
    g = MolGraph()
    cur: Optional[int] = None
    stack: List[int] = []
    for t in np.asarray(tokens, int).ravel():
        kind, arg, order = ALPHABET[int(t) % N_TOKENS]
        if kind == "nop":
            continue
        if kind == "atom":
            j = g.add_atom(arg)
            if cur is not None:
                if not g.add_bond(cur, j, order):
                    # no capacity on cur: start a new fragment root
                    pass
            cur = j
        elif kind == "branch":
            if cur is not None:
                stack.append(cur)
        elif kind == "pop":
            if stack:
                cur = stack.pop()
        elif kind == "ring":
            if cur is not None:
                back = int(arg)
                j = cur - 1 - back
                if j >= 0:
                    g.add_bond(cur, j, order)
    if not g.atoms:
        g.add_atom("C")  # empty sequence decodes to methane
    return g


def canonical_string(g: MolGraph) -> str:
    """Deterministic serialization for dedupe (degree-sorted DFS)."""
    n = len(g.atoms)
    adj = {i: [] for i in range(n)}
    for a, b, o in g.bonds:
        adj[a].append((b, o))
        adj[b].append((a, o))
    seen = set()
    frags = []
    for root in sorted(range(n), key=lambda i: (g.atoms[i], -len(adj[i]))):
        if root in seen:
            continue
        out = []
        stack = [(root, 0)]
        while stack:
            i, o = stack.pop()
            if i in seen:
                out.append(f"r{o}")
                continue
            seen.add(i)
            out.append(("", "=", "#")[o - 1] + g.atoms[i] if o > 1 else g.atoms[i])
            for j, oj in sorted(adj[i], key=lambda t: (g.atoms[t[0]], t[1])):
                if j not in seen:
                    stack.append((j, oj))
        frags.append("".join(out))
    return ".".join(sorted(frags))


def penalized_logp_proxy(g: MolGraph) -> float:
    """Deterministic penalized-logP-shaped objective (maximize).

    logP term: Crippen-style additive contributions; penalties: cycle-rank
    (SA/ring-size analogue) and fragment count; small size regularizer so
    the optimum isn't a trivial max-length carbon chain."""
    logp = sum(LOGP_CONTRIB[a] for a in g.atoms)
    n = len(g.atoms)
    n_frag = _n_fragments(g)
    cycle_rank = len(g.bonds) - n + n_frag
    double_bonds = sum(1 for _, _, o in g.bonds if o >= 2)
    return (
        logp
        - 0.8 * max(cycle_rank - 1, 0)
        - 1.5 * (n_frag - 1)
        + 0.3 * double_bonds
        - 0.02 * (n - 20) ** 2 / 20.0
    )


def _n_fragments(g: MolGraph) -> int:
    n = len(g.atoms)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b, _ in g.bonds:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    return len({find(i) for i in range(n)})


def random_molecules(n: int, length: int = 24, seed: int = 0) -> np.ndarray:
    """Random token sequences (all valid by construction) — the hermetic
    stand-in for the reference's ZINC-250k SMILES dataset."""
    rng = np.random.default_rng(seed)
    # bias towards atoms so molecules have a reasonable size
    probs = np.asarray(
        [0.08] + [0.12, 0.07, 0.07, 0.04, 0.04, 0.05, 0.03, 0.03, 0.02, 0.02]
        + [0.08, 0.08, 0.09, 0.09, 0.09]
    )
    probs = probs / probs.sum()
    return rng.choice(N_TOKENS, size=(n, length), p=probs).astype(np.int32)


class ChemLatentBO:
    """T-LBO weighted retraining on the SELFIES-style chem task.

    Mirrors robust_opt_chem.py: encode dataset → rank-weighted VAE
    retraining every ``retrain_every`` iterations → GP + EI in latent
    space → decode candidates → score; all molecules deduped on the
    canonical serialization.  Walls per phase: ``retrain_time``,
    ``fit_time``, ``acq_time``, ``decode_time``."""

    def __init__(
        self,
        n_init: int = 128,
        seq_len: int = 24,
        latent_dim: int = 8,
        retrain_every: int = 8,
        rank_k: float = 1e-2,
        seed: int = 0,
        vae_steps: int = 300,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.seq_len = seq_len
        self.latent_dim = latent_dim
        self.retrain_every = retrain_every
        self.rank_k = rank_k
        self.seed = seed
        self.vae_steps = vae_steps
        self.tokens = random_molecules(n_init, seq_len, seed)
        self.y = np.asarray(
            [penalized_logp_proxy(decode_tokens(t)) for t in self.tokens]
        )
        self._seen = {canonical_string(decode_tokens(t)) for t in self.tokens}
        self.model = SeqVAE(vocab=N_TOKENS, length=seq_len, latent_dim=latent_dim, seed=seed,
                            device=self.device)
        self._params = init_params(self.model)
        self._iter = 0
        self.retrain_time: list = []
        self.fit_time: list = []
        self.acq_time: list = []
        self.decode_time: list = []
        self._retrain()

    # ---------------------------------------------------------------- VAE
    def _retrain(self):
        w = rank_weights(-self.y, k=self.rank_k)  # maximize → rank by -y
        gen = torch.Generator(device=self.device).manual_seed(self.seed + self._iter)
        with timed(self.retrain_time, self.device):
            self._params, _losses = train_seq_vae(
                self.model, self._params, self.tokens,
                (-self.y).reshape(-1, 1).astype(np.float32), w.astype(np.float32),
                n_steps=self.vae_steps, generator=gen,
            )

    def _encode(self, tokens):
        return seq_encode(self.model, self._params, tokens)

    def _decode(self, Z):
        return seq_decode(self.model, self._params, Z)

    def _take_new(self, toks: np.ndarray, batch: int):
        """Walk decoded rows in order: keep each molecule not seen before
        (marking it seen), up to ``batch``.  Returns (tokens, scores)."""
        new_tok, new_y = [], []
        for t in toks:
            g = decode_tokens(t)
            s = canonical_string(g)
            if s in self._seen:
                continue
            self._seen.add(s)
            new_tok.append(t)
            new_y.append(penalized_logp_proxy(g))
            if len(new_tok) >= batch:
                break
        return new_tok, new_y

    # ----------------------------------------------------------------- BO
    def step(self, batch: int = 4) -> float:
        """One weighted-retraining BO iteration; returns current best."""
        self._iter += 1
        if self._iter % self.retrain_every == 0:
            self._retrain()

        with timed(self.fit_time, self.device):
            Z = self._encode(self.tokens)
            lo, hi = Z.min(0) - 0.5, Z.max(0) + 0.5
            space = DesignSpace().parse([
                {"name": f"z{i}", "type": "num", "lb": float(lo[i]), "ub": float(hi[i])}
                for i in range(self.latent_dim)
            ])
            gp = get_model("gp", space, num_out=1, num_epochs=30, n_restarts=1, device=self.device)
            yv = -self.y.reshape(-1, 1)  # minimize -objective
            gp.fit(Z.astype(np.float32), yv)
        with timed(self.acq_time, self.device):
            tau = float(yv.min())
            params = AcqParams(tau=tau, seed=self._iter)
            evo = EvolutionOpt(space, EI(), pop=64, iters=32)
            Zc, _ = evo.optimize(model=gp, acq_params=params, return_pop=True, seed=self._iter)
        # decode the whole population at once, then dedupe and score in order
        with timed(self.decode_time, self.device):
            new_tok, new_y = self._take_new(self._decode(Zc), batch)
        if new_tok:
            self.tokens = np.vstack([self.tokens, np.stack(new_tok)])
            self.y = np.concatenate([self.y, np.asarray(new_y)])
        return float(self.y.max())

    @property
    def best_y(self) -> float:
        return float(self.y.max())
