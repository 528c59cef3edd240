"""Context-specific sequence profiles (Biegert & Söding 2009).

Re-derivation of CSProfile.{h,cpp}: parse a
CS-BLAST-style profile library (K4000.lib text format, CSProfile.cpp:29-170)
and soften leaf sequences into profiles (createProfile,
CSProfile.cpp:175-225).

The O(L·nprof·ncols) scoring loop is restructured as array ops:

    pk[k, i] = prior[k] + sum_j lprofiles[k][j, tseq[i+j-center]]

via a windowed gather (out-of-range and invalid residues hit the zeroed
DIM-th column, exactly like the reference's bounds check), followed by one
[L, K] @ [K, 20] profile-mixing GEMM — MXU-shaped on device, float64 numpy
on the parity path.
"""

from __future__ import annotations

import math

import numpy as np

from .alphabet import AA_SPEC

W_CENTER = 0.26236426446749105203   # log(1.3)
BETA = -0.10536051565782630122      # log(.9)
LOG_2 = 0.69314718055994530941

DIM = 20


class CSProfileError(Exception):
    pass


class CSProfileLibrary:
    """Parsed profile library: priors [K], lprofiles [K, ncols, 21]
    (position-weighted log-probs, col 20 = 0), center profiles [K, 20]."""

    def __init__(self, filename: str):
        self._cache = {}
        with open(filename) as f:
            lines = f.read().split("\n")
        it = iter(lines)
        first = next(it, None)
        if first is None or not first.startswith("ProfileLibrary"):
            raise CSProfileError("error opening profile library")

        self.nprof = -1
        self.ncols = -1
        line = ""
        for line in it:
            if not line or line[0] == "#":
                continue
            if line.startswith("NPROF"):
                self.nprof = int(line.split()[1])
            elif line.startswith("NCOLS"):
                self.ncols = int(line.split()[1])
            elif line.startswith("ITERS") or line.startswith("LOG"):
                continue
            elif line.startswith("ContextProfile"):
                break
            else:
                raise CSProfileError("parse error: " + line)
        if self.nprof <= 0 or self.ncols <= 0:
            raise CSProfileError("missing information in header")

        center = self.ncols // 2
        j = np.arange(-center, center + 1)
        self.weights = np.exp(W_CENTER + BETA * np.abs(j))

        self.priors = np.zeros(self.nprof)
        self.lprofiles = np.zeros((self.nprof, self.ncols, DIM + 1))
        self.profiles = np.zeros((self.nprof, self.ncols, DIM))

        # parse profiles; `line` currently holds "ContextProfile"
        while True:
            if not line or line[0] == "#":
                line = next(it, None)
                if line is None:
                    break
                continue
            if not line.startswith("ContextProfile"):
                raise CSProfileError("parse error: " + line)
            index = -1
            prior = -1.0
            profile = np.zeros((self.ncols, DIM))
            cols = None
            done = False
            for line in it:
                if not line or line[0] == "#" or line.startswith("ITERS"):
                    continue
                if line.startswith("INDEX"):
                    index = int(line.split()[1])
                    if not (0 <= index < self.nprof):
                        raise CSProfileError("parse error: " + line)
                elif line.startswith("PRIOR"):
                    prior = float(line.split()[1])
                elif line.startswith("NCOLS"):
                    if int(line.split()[1]) != self.ncols:
                        raise CSProfileError("parse error: " + line)
                elif line.startswith("ALPH"):
                    if int(line.split()[1]) != DIM:
                        raise CSProfileError("parse error: " + line)
                elif line.startswith("LOG"):
                    continue
                elif line[0].isspace():
                    toks = line.split()
                    cols = [int(AA_SPEC.values(AA_SPEC.encode(t))[0])
                            for t in toks[:DIM]]
                    if any(c < 0 or c >= DIM for c in cols):
                        raise CSProfileError("parse error in column names")
                    for line in it:
                        if line == "//":
                            done = True
                            break
                        toks = line.split()
                        col = int(toks[0])
                        if not (0 < col <= self.ncols):
                            raise CSProfileError("invalid column number")
                        for i in range(DIM):
                            v = float(toks[1 + i])
                            if v < 0:
                                raise CSProfileError("parse error in profile")
                            profile[col - 1, cols[i]] = v
                    if done:
                        break
                else:
                    raise CSProfileError("parse error: " + line)
            if not (0 <= index < self.nprof):
                raise CSProfileError("parse error: invalid index")
            # -1000*log2 encoded probabilities; renormalize per column
            # (CSProfile.cpp:157-162)
            p = np.exp(profile * (-LOG_2 / 1000.0))
            lp = np.log(p) - np.log(p.sum(axis=1))[:, None]
            self.lprofiles[index, :, :DIM] = lp
            self.profiles[index] = np.exp(lp)
            self.lprofiles[index] *= self.weights[:, None]
            if prior <= 0:
                raise CSProfileError("parse error: invalid prior")
            self.priors[index] = math.log(prior)

            line = next(it, None)
            if line is None:
                break

    # ------------------------------------------------------------------
    def prime_profiles(self, items, engine: str = "native",
                       device=None) -> None:
        """Batch-compute the profiles of many (seq, model) leaves in ONE
        pass — one windowed-gather sweep and one [ΣL, K] @ [K, 20] mixing
        GEMM instead of per-leaf passes (the reference recomputes each leaf
        separately, CSProfile.cpp:175) — and cache them for create_profile.

        Host float64 by default: CS profiles feed the S matrices whose
        rounding decides alignment paths.  Under the ``device`` engine
        (engine_policy.use_device_cs) the window scores and the mix run on
        ``device`` in float32 (``_pk_mix_device``); the admixture stays
        float64 on the host.

        Leaf windows never cross leaves: each sequence is padded with
        ``center`` sentinel residues on both sides, so position windows of
        adjacent leaves only ever overlap the shared sentinel gap."""
        todo = [(seq, model) for (seq, model) in items
                if self._key(seq, model) not in self._cache]
        if not todo:
            return
        center = self.ncols // 2
        gap = np.full(center, DIM, dtype=np.int64)
        chunks = []
        starts = []
        lens = []
        off = 0
        for seq, _model in todo:
            vals = AA_SPEC.values(seq)
            t = np.where((vals >= 0) & (vals < DIM), vals,
                         DIM).astype(np.int64)
            chunks.append(gap)
            chunks.append(t)
            starts.append(off + center)
            lens.append(len(t))
            off += center + len(t)
        chunks.append(gap)
        big = np.concatenate(chunks)
        idx = np.concatenate([np.arange(s, s + n)
                              for s, n in zip(starts, lens)]) \
            if sum(lens) else np.zeros(0, np.int64)
        tseq_all = big[idx]

        win = big[idx[:, None] + np.arange(-center, center + 1)[None, :]]
        from .engine_policy import use_device_cs
        if use_device_cs(engine):
            mix = self._pk_mix_device(win, center, device)
        else:
            lp = self.lprofiles.transpose(1, 2, 0)      # [ncols, 21, K]
            pk = np.zeros((len(idx), self.nprof))
            for j in range(self.ncols):
                pk += lp[j][win[:, j]]
            pk += self.priors[None, :]
            mix = np.exp(pk) @ self.profiles[:, center, :]  # [ΣL, 20]

        pos = 0
        for (seq, model), n in zip(todo, lens):
            self._cache[self._key(seq, model)] = self._finalize(
                mix[pos:pos + n], tseq_all[pos:pos + n], model)
            pos += n

    def _pk_mix_device(self, win, center, device):
        """Window scores and mix on ``device`` (CSProfile.cpp:190-203 as two
        float32 products, TF32 off): pk = onehot(win) contracted with the
        log library over (column, residue), plus the priors; mix = exp(pk)
        @ the centre profiles.  Returns float64 [ΣL, 20]."""
        import torch

        from .device import full_float32

        full_float32()
        f32 = torch.float32
        lp = torch.as_tensor(self.lprofiles, dtype=f32, device=device)
        oh = torch.nn.functional.one_hot(
            torch.as_tensor(win, device=device), DIM + 1).to(f32)
        pk = torch.matmul(oh.reshape(len(win), self.ncols * (DIM + 1)),
                          lp.reshape(self.nprof, -1).T)
        pk = pk + torch.as_tensor(self.priors, dtype=f32, device=device)
        mix = torch.matmul(torch.exp(pk), torch.as_tensor(
            self.profiles[:, center, :], dtype=f32, device=device))
        return mix.cpu().numpy().astype(np.float64)

    def _key(self, seq, model):
        return (seq.tobytes(), float(model.distance),
                float(model.divergence))

    def _finalize(self, mix, tseq, model) -> np.ndarray:
        """Per-position admixture with the observed residue
        (CSProfile.cpp:204-223); float64 op order identical to the scalar
        loop."""
        L = len(tseq)
        tau = model.divergence / 0.8
        profile = np.zeros((L + 2, DIM))
        inv_pi = (1.0 / 20.0) / model.pi
        for i in range(L):
            row = mix[i]
            c = int(tseq[i])
            s = row.sum()
            if s <= 0:
                profile[i + 1] = model.P @ np.full(DIM, 1.0 / 20)
            elif c < 0 or c > 19:
                profile[i + 1] = (row / s) * inv_pi
            else:
                row = row * (tau / s)
                row[c] += 1.0 - tau
                if row[c] <= 0.0:
                    row[c] = 1e-3
                profile[i + 1] = row * inv_pi
        return profile

    def create_profile(self, seq: np.ndarray, model) -> np.ndarray:
        """createProfile (CSProfile.cpp:175-225).

        ``seq``: encoded AA sequence.  Returns [L+2, 20] profile incl. zero
        sentinels (the reference returns DIM x (L+2); ours is row-major)."""
        cached = self._cache.get(self._key(seq, model))
        if cached is not None:
            return cached
        vals = AA_SPEC.values(seq)
        L = len(vals)
        tseq = np.where((vals >= 0) & (vals < DIM), vals, DIM).astype(np.int64)

        center = self.ncols // 2
        # windowed residue indices [L, ncols]; out-of-range -> DIM (zero col)
        pos = np.arange(L)[:, None] + np.arange(-center, center + 1)[None, :]
        inb = (pos >= 0) & (pos < L)
        win = np.where(inb, tseq[np.clip(pos, 0, max(L - 1, 0))], DIM)

        # pk[i, k] = prior[k] + sum_j lprofiles[k, j, win[i, j]]
        lp = self.lprofiles.transpose(1, 2, 0)       # [ncols, 21, K]
        pk = np.zeros((L, self.nprof))
        for j in range(self.ncols):
            pk += lp[j][win[:, j]]
        pk += self.priors[None, :]

        mix = np.exp(pk) @ self.profiles[:, center, :]   # [L, 20]
        return self._finalize(mix, tseq, model)


def cs_sequence_graph(spec, seq: np.ndarray, csprofile: CSProfileLibrary,
                      model):
    """SequenceGraph(seq, csprofile, model) (SequenceGraph.h:111-121)."""
    from .graph.graph import Graph
    prof = csprofile.create_profile(seq, model)
    g = Graph.from_profile(prof[1:-1])
    return g
