"""Plain PyTorch reference of the AO-ADMM fits the benchmark times.

Written from the reference equations (cmtf_fun_AOADMM.m: the constrained
ADMM of an uncoupled mode, the type-4 coupled ADMM with its normal-equation
Delta solve, :904-983, the objective streams, :1213-1363, and the outer
stopping rule), after the numpy oracle the repository's tests hold the
solvers to.  It covers what the benchmark's configurations use: CP datasets
(dense 3-way tensors and matrices) with Frobenius loss, non-negativity on
every mode, and at most one type-4 coupling.

It imports nothing of the program and takes nothing the program made: the
data come from the benchmark's generator (`raw`), the initial state is
drawn again from the job's key in the program's documented draw order
(init_state), and every derived quantity (data norms, Gram matrices,
MTTKRPs, the step sizes) is worked out here.  It runs in float64 on
whatever device holds the data, one start at a time, with one host read an
inner iteration.
"""
from __future__ import annotations

import torch

def _fro(x):
    return torch.linalg.vector_norm(x)


def _ratio(num, den):
    """num / den where den > 0, else num (the reference's residual rule)."""
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), num)


def init_state(raw, key: int, dtype, device):
    """The initial state the program draws for `key` (its init_coupled with
    distr 'rand' on every mode, normalized columns, lambdas 1): a generator
    on `device` seeded with the key; per dataset and mode the factor, then
    per dataset and mode the constraint auxiliary (through the
    non-negativity prox) and its dual, then the coupling's Delta and each
    coupled mode's dual.  Drawn in the program's dtype, returned in float64."""
    g = torch.Generator(device=device)
    g.manual_seed(int(key))

    def rand(shape):
        return torch.rand(shape, generator=g, dtype=dtype, device=device)

    sizes = raw["mode_sizes"]
    fac, Z, U = {}, {}, {}
    for ds in raw["datasets"]:
        for n in ds["modes"]:
            A = rand((sizes[n], ds["rank"]))
            fac[n] = A / torch.linalg.vector_norm(A, dim=0, keepdim=True)
    for ds in raw["datasets"]:
        for n in ds["modes"]:
            Z[n] = torch.clamp(rand(fac[n].shape), min=0.0)
            U[n] = rand(fac[n].shape)
    Delta, muD = None, {}
    cpl = raw.get("coupling")
    if cpl is not None:
        m1 = cpl["modes"][0]
        Delta = rand((fac[m1].shape[0], cpl["H"][m1].shape[0]))
        for m in cpl["modes"]:
            muD[m] = rand(fac[m].shape)
    f64 = lambda d: {k: v.to(torch.float64) for k, v in d.items()}
    return {"fac": f64(fac), "Z": f64(Z), "U": f64(U), "muD": f64(muD),
            "Delta": None if Delta is None else Delta.to(torch.float64)}


class Reference:
    """One start's AO-ADMM fit of `raw` under `opts` (a mapping that holds
    MaxInnerIters and the inner and outer tolerances), in float64."""

    def __init__(self, raw, opts, dtype=torch.float64):
        self.dt = dtype
        self.opts = opts
        self.ds = []
        for d in raw["datasets"]:
            e = {"modes": tuple(d["modes"]), "w": float(d["weight"]),
                 "rank": d["rank"]}
            e["X"] = d["dense"].to(dtype)
            e["znorm"] = torch.sum(e["X"] * e["X"])
            self.ds.append(e)
        cpl = raw.get("coupling")
        self.coupled = () if cpl is None else tuple(cpl["modes"])
        self.H = {} if cpl is None else {m: h.to(dtype)
                                         for m, h in cpl["H"].items()}
        self.modes = [m for e in self.ds for m in e["modes"]]

    # -- data terms -------------------------------------------------------
    def _dataset(self, m):
        for e in self.ds:
            if m in e["modes"]:
                return e
        raise KeyError(m)

    def mttkrp(self, e, local, fac):
        facs = [fac[j] for j in e["modes"]]
        X = e["X"]
        if X.dim() == 2:
            return X @ facs[1] if local == 0 else X.T @ facs[0]
        eq = {0: "ijk,jr,kr->ir", 1: "ijk,ir,kr->jr", 2: "ijk,ir,jr->kr"}
        rest = [f for i, f in enumerate(facs) if i != local]
        return torch.einsum(eq[local], X, *rest)

    # -- one outer iteration ------------------------------------------------
    def _precompute(self, st, m):
        e = self._dataset(m)
        local = e["modes"].index(m)
        mk = self.mttkrp(e, local, st["fac"])
        C = None
        for j in e["modes"]:
            if j != m:
                G = st["gram"][j]
                C = G if C is None else C * G
        rho = torch.trace(C) / C.shape[0]
        st["last"][id(e)] = (mk, C, m)
        return e["w"] * mk, e["w"] * C, rho

    def _solve(self, B, A):
        """X with X B = A."""
        return torch.linalg.solve(B.T, A.T).T

    def _admm_constrained(self, st, m, A, B, rho):
        o = self.opts
        fac, Z, U = st["fac"], st["Z"], st["U"]
        Bc = B + rho / 2 * torch.eye(B.shape[0], dtype=self.dt,
                                     device=B.device)
        it = 1
        while it <= o["MaxInnerIters"]:
            fac[m] = self._solve(Bc, A + rho / 2 * (Z[m] - U[m]))
            oldZ = Z[m]
            Z[m] = torch.clamp(fac[m] + U[m], min=0.0)
            U[m] = U[m] + fac[m] - Z[m]
            pr = _fro(fac[m] - Z[m]) / _fro(fac[m])
            dr = _ratio(_fro(Z[m] - oldZ), _fro(U[m]))
            pr, dr = torch.stack([pr, dr]).tolist()
            it += 1
            if not (pr > o["innerRelPrTol_constr"]
                    or dr > o["innerRelDualTol_constr"]):
                break

    def _admm_coupled4(self, st, pre):
        o = self.opts
        fac, Z, U, muD = st["fac"], st["Z"], st["U"], st["muD"]
        cm = self.coupled
        Bc = {}
        for m in cm:
            _, B, rho = pre[m]
            eye = torch.eye(B.shape[0], dtype=self.dt, device=B.device)
            Bc[m] = B + rho / 2 * eye + rho / 2 * eye
        it = 1
        while it <= o["MaxInnerIters"]:
            for m in cm:
                A, _, rho = pre[m]
                Ai = (A + rho / 2 * (st["Delta"] @ self.H[m] - muD[m])
                      + rho / 2 * (Z[m] - U[m]))
                fac[m] = self._solve(Bc[m], Ai)
            oldD = st["Delta"]
            AA = BB = 0.0
            for m in cm:
                rho, H = pre[m][2], self.H[m]
                AA = AA + rho * H @ H.T
                BB = BB + rho * (fac[m] + muD[m]) @ H.T
            st["Delta"] = self._solve(AA, BB)
            oldZ = {}
            for m in cm:
                muD[m] = muD[m] + fac[m] - st["Delta"] @ self.H[m]
                oldZ[m] = Z[m]
                Z[m] = torch.clamp(fac[m] + U[m], min=0.0)
                U[m] = U[m] + fac[m] - Z[m]
            prk = sum(_fro(fac[m] - st["Delta"] @ self.H[m]) / _fro(fac[m])
                      for m in cm) / len(cm)
            drk = sum(_ratio(_fro((st["Delta"] - oldD) @ self.H[m]),
                             _fro(muD[m])) for m in cm) / len(cm)
            prc = sum(_fro(fac[m] - Z[m]) / _fro(fac[m]) for m in cm) / len(cm)
            drc = sum(_ratio(_fro(Z[m] - oldZ[m]), _fro(U[m]))
                      for m in cm) / len(cm)
            prk, prc, drk, drc = torch.stack([prk, prc, drk, drc]).tolist()
            it += 1
            if not (prk > o["innerRelPrTol_coupl"]
                    or prc > o["innerRelPrTol_constr"]
                    or drk > o["innerRelDualTol_coupl"]
                    or drc > o["innerRelDualTol_constr"]):
                break

    def sweep(self, st):
        for e in self.ds:
            for m in e["modes"]:
                if m in self.coupled:
                    continue
                A, B, rho = self._precompute(st, m)
                self._admm_constrained(st, m, A, B, rho)
                st["gram"][m] = st["fac"][m].T @ st["fac"][m]
        if self.coupled:
            pre = {m: self._precompute(st, m) for m in self.coupled}
            self._admm_coupled4(st, pre)
            for m in self.coupled:
                st["gram"][m] = st["fac"][m].T @ st["fac"][m]

    def objective(self, st, fresh=False):
        """The four streams (f_tensors, f_couplings, f_constraints, 0):
        each data term from the MTTKRP of the mode its dataset updated
        last, as the reference caches it, or afresh (fresh=True)."""
        fac, gram = st["fac"], st["gram"]
        f = torch.zeros((), dtype=self.dt, device=fac[self.modes[0]].device)
        for e in self.ds:
            if fresh:
                m = e["modes"][0]
                mk = self.mttkrp(e, 0, fac)
                had = None
                for j in e["modes"][1:]:
                    had = gram[j] if had is None else had * gram[j]
            else:
                mk, had, m = st["last"][id(e)]
            f = f + e["w"] * (e["znorm"] - 2 * torch.sum(mk * fac[m])
                              + torch.sum(had * gram[m]))
        fc = torch.zeros_like(f)
        for m in self.coupled:
            fc = fc + _fro(fac[m] - st["Delta"] @ self.H[m]) / _fro(fac[m])
        vals = torch.stack([_fro(fac[m] - st["Z"][m]) / _fro(fac[m])
                            for m in self.modes])
        nnz = torch.sum(vals != 0)
        fz = torch.where(nnz > 0, vals.sum() / torch.clamp(nnz, min=1),
                         vals.sum())
        return torch.stack([f, fc, fz, torch.zeros_like(f)])

    def _stop(self, f4, f4_old):
        o = self.opts
        for f, g in zip(f4, f4_old):
            rel = abs(g - f) / g if g > 0 else abs(g - f)
            if not (f < o["AbsFuncTol"] or rel < o["OuterRelTol"]):
                return False
        return True

    def fit(self, state0, max_iters: int, at_least: int = 0):
        """Fit from state0.  Runs until the stopping rule holds or
        max_iters, and on to iteration `at_least` if that is later.
        Returns (history of the four streams, one row an iteration from 0,
        the iteration at which the stopping rule held (max_iters if never),
        the factors after iteration `at_least`, or the final ones)."""
        st = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in state0.items()}
        st["gram"] = {m: F.T @ F for m, F in st["fac"].items()}
        st["last"] = {}
        hist = [self.objective(st, fresh=True).tolist()]
        n_stop = None
        snap = dict(st["fac"])
        it = 1
        while it <= max(max_iters, at_least):
            if n_stop is not None and it > at_least:
                break
            self.sweep(st)
            hist.append(self.objective(st).tolist())
            f4 = hist[-1]
            if n_stop is None and (not all(map(_finite, f4))
                                   or self._stop(f4, hist[-2])):
                n_stop = it
            if n_stop is None and it == max_iters:
                n_stop = it
            if it == at_least:
                snap = dict(st["fac"])
            it += 1
        return hist, n_stop, (snap if at_least else st["fac"])


def _finite(v):
    return v == v and abs(v) != float("inf")
