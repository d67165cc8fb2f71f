"""Message-passing acquisition optimizer over a clique tree (RDUCB; port of
``hebo_tpu/acq_optimizers/message_passing.py``).

The additive acquisition A(x) = Σ_edges a_ij(x_i, x_j) (the per-clique LCB
of the random-decomposition GP) is minimised exactly over a grid by
min-sum dynamic programming on the spanning tree; disjoint cliques of any
other size are minimised over their own grid meshes.  Continuous dims are
refined by zooming: re-grid around the incumbent with a shrunken span and
re-solve.  Extra suggestions re-solve on jittered grids.

The DP is host numpy, as in the JAX package.  The edge and clique tables
of one solve come from the model's ``predict_cliques``: all cliques with
the same number of grid points in one batched posterior evaluation on the
model's device (one per distinct count), where the JAX package evaluates
one clique per call.  Overlapping general cliques raise ``ValueError``
where the JAX package asserts.
"""

from __future__ import annotations

import numpy as np

from .mcbo_opts import AcqOptimizerBase

__all__ = ["MessagePassingOptimizer"]


class MessagePassingOptimizer(AcqOptimizerBase):
    def __init__(self, space, grid_size: int = 16, n_zoom: int = 2, kappa: float = 2.0, **kw):
        super().__init__(space, **kw)
        self.grid_size = grid_size
        self.n_zoom = n_zoom
        self.kappa = kappa

    # ------------------------------------------------------------ domains
    def _grids(self, lb, ub, center=None, shrink=1.0):
        """Per-dim value grids (lists of arrays, len ≤ grid_size)."""
        g = self.grid_size
        grids = []
        for d in range(self.space.num_cols):
            if d in self.space.cat_dims:
                grids.append(np.arange(int(self.space.num_categories[d]), dtype=float))
            else:
                lo, hi = lb[d], ub[d]
                if center is not None and shrink < 1.0:
                    span = (hi - lo) * shrink
                    lo = max(lb[d], center[d] - span / 2)
                    hi = min(ub[d], center[d] + span / 2)
                if d in self.space.discrete_numeric_dims:
                    vals = np.unique(np.round(np.linspace(lo, hi, g)))
                else:
                    vals = np.linspace(lo, hi, g)
                grids.append(vals)
        return grids

    # ----------------------------------------------------------- dp solve
    def _solve(self, model, kappa, grids, base_point):
        """One exact min-sum pass; returns (x*, value).  Pairwise edges that
        share dims form the spanning-tree DP; every other clique must be
        disjoint from the rest and is minimised over its own grid mesh."""
        space = self.space
        cliques = [tuple(dict.fromkeys(c)) for c in model.cliques]
        D = space.num_cols

        pair_edges = [(e, c) for e, c in enumerate(cliques) if len(c) == 2]
        solo = [(e, c) for e, c in enumerate(cliques) if len(c) != 2]
        seen = {d for _, c in pair_edges for d in c}
        for _, c in solo:
            if set(c) & seen:
                raise ValueError("exact maximization needs tree edges or a disjoint partition; "
                                 "overlapping general cliques require a GA/interleaved optimizer")
            seen.update(c)

        # every clique's query set: its dims over their grid mesh, the rest
        # at the base point
        queries, meshes = [], {}
        for e_idx, dims in solo + pair_edges:
            mesh = np.meshgrid(*[grids[d] for d in dims], indexing="ij")
            Xq = np.repeat(base_point[None, :], mesh[0].size, axis=0)
            for k, d in enumerate(dims):
                Xq[:, d] = mesh[k].ravel()
            queries.append((e_idx, Xq))
            meshes[e_idx] = mesh
        mus, vars_ = model.predict_cliques([q for _, q in queries], [e for e, _ in queries])
        lcb = {e: mu[:, 0] - kappa * np.sqrt(var[:, 0])
               for (e, _), mu, var in zip(queries, mus, vars_)}

        x_star = base_point.copy()
        total_val = 0.0
        # independent exact minimum per disjoint clique
        for e_idx, dims in solo:
            b = int(np.argmin(lcb[e_idx]))
            total_val += float(lcb[e_idx][b])
            for k, d in enumerate(dims):
                x_star[d] = meshes[e_idx][k].ravel()[b]

        # tree structure: adjacency from the pairwise clique edges
        adj = {d: [] for d in range(D)}
        for e_idx, (i, j) in pair_edges:
            adj[i].append((j, e_idx))
            adj[j].append((i, e_idx))
        tables = {e: lcb[e].reshape(len(grids[i]), len(grids[j])) for e, (i, j) in pair_edges}

        # forests: one root per component
        visited = set()
        for root in range(D):
            if root in visited or not adj[root]:
                continue
            order, stack, comp = [], [(root, -1)], []
            while stack:
                node, parent = stack.pop()
                if node in visited:
                    continue
                visited.add(node)
                comp.append(node)
                order.append((node, parent))
                for nb, e in adj[node]:
                    if nb != parent and nb not in visited:
                        stack.append((nb, node))
            # messages leaf → root (reverse of discovery order)
            msg = {d: np.zeros(len(grids[d])) for d in comp}
            argmin_tab = {}
            for node, parent in reversed(order):
                if parent < 0:
                    continue
                e_idx = next(e for nb, e in adj[node] if nb == parent)
                i, j = cliques[e_idx]
                T = tables[e_idx]  # [gi, gj]
                if i == node:
                    score = T + msg[node][:, None]
                    best, argm = np.min(score, axis=0), np.argmin(score, axis=0)
                else:
                    score = T + msg[node][None, :]
                    best, argm = np.min(score, axis=1), np.argmin(score, axis=1)
                msg[parent] = msg[parent] + best
                argmin_tab[(node, parent)] = argm
            # root decision + traceback
            r_best = int(np.argmin(msg[root]))
            total_val += float(msg[root][r_best])
            choice = {root: r_best}
            for node, parent in order:
                if parent < 0:
                    continue
                choice[node] = int(argmin_tab[(node, parent)][choice[parent]])
            for d in comp:
                x_star[d] = grids[d][choice[d]]
        return self.space.round_opt(x_star), total_val

    # ---------------------------------------------------------------- api
    def optimize(self, model, acq, acq_params, n_suggestions=1, x_observed=None,
                 tr_manager=None, seed=0):
        if not hasattr(model, "predict_cliques"):
            raise ValueError("MessagePassingOptimizer needs a decomposition model (gp_rd)")
        tr = self._tr(tr_manager)
        lb, ub = tr.numeric_bounds()
        kappa = float(acq_params.kappa)
        base = (tr.center.copy() if tr.center is not None
                else self.space.sobol_sample_opt(1, seed=seed)[0])
        grids = self._grids(lb, ub)
        x, val = self._solve(model, kappa, grids, base)
        shrink = 1.0
        for _ in range(self.n_zoom):  # zooming refinement
            shrink *= 0.3
            grids = self._grids(lb, ub, center=x, shrink=shrink)
            x2, v2 = self._solve(model, kappa, grids, x)
            if v2 < val:
                x, val = x2, v2
        out = [x]
        # extra batch suggestions: re-solves on jittered grids
        rng = np.random.default_rng(seed)
        while len(out) < n_suggestions:
            g2 = self._grids(lb, ub, center=None)
            g2 = [v + (rng.random() - 0.5) * (v[1] - v[0])
                  if len(v) > 1 and d not in self.space.cat_dims else v
                  for d, v in enumerate(g2)]
            g2 = [np.clip(v, lb[d], ub[d]) for d, v in enumerate(g2)]
            xi, _ = self._solve(model, kappa, g2, base)
            out.append(xi)
        return np.stack(out[:n_suggestions])
