"""Pure-Python executable specification of the BCR/rope insertion algorithm.

This is the framework's correctness oracle: a direct, slow, obviously-correct
implementation of the algorithm the reference implements with six B+-trees
(mr_insert1: mrope.c:42-68; mr_insert_multi: mrope.c:184-345).  Here the six
BWT partitions are plain Python lists of symbols; rank is a prefix count and
insertion is list splicing.  The JAX engine is tested against this, and
this in turn is tested against a brute-force suffix sort (bruteforce.py) and
the compiled reference binary.

Sorting orders: 0 = input order (IO), 1 = reverse-lexicographic (RLO),
2 = reverse-complement-lexicographic (RCLO), matching MR_SO_* (mrope.h:6-8).
"""

from .alphabet import NSYM

SO_IO, SO_RLO, SO_RCLO = 0, 1, 2


class _Str:
    """Per-string BCR state: interval [l,u), last inserted symbol c, cursor.

    The reference packs this into triple64_t (mrope.c:174-178)."""

    __slots__ = ("l", "u", "c", "s", "pos")

    def __init__(self, s):
        self.s = s
        self.pos = 0
        self.l = self.u = 0
        self.c = 0

    def next_sym(self):
        c = self.s[self.pos] if self.pos < len(self.s) else 0
        self.pos += 1
        return c


class OracleIndex:
    """The six-partition BWT with rank + positional insertion.

    Partition b holds the BWT range B[C(b)..C(b+1)) — all BWT symbols whose
    next text symbol is b (mrope.h:10-14)."""

    def __init__(self, so=SO_IO):
        assert 0 <= so <= 2
        self.so = so
        self.B = [[] for _ in range(NSYM)]

    # --- primitive index ops (the "rope" interface) ---

    def part_counts(self, b):
        cnt = [0] * NSYM
        for x in self.B[b]:
            cnt[x] += 1
        return cnt

    def counts(self):
        """Global per-symbol counts, like mr_get_c (mrope.h:95-103)."""
        tot = [0] * NSYM
        for b in range(NSYM):
            for x in self.B[b]:
                tot[x] += 1
        return tot

    def rank2a(self, b, l, u):
        """Counts of each symbol in B_b[0:l] and B_b[0:u] (rope_rank2a)."""
        tl = [0] * NSYM
        part = self.B[b]
        for i in range(l):
            tl[part[i]] += 1
        tu = list(tl)
        for i in range(l, u):
            tu[part[i]] += 1
        return tl, tu

    def insert_run(self, b, x, a, n):
        """Insert n copies of symbol a before position x of partition b and
        return rank(a, x) — the count of a in B_b[0:x] before insertion
        (rope_insert_run's contract, rope.c:114-148)."""
        part = self.B[b]
        r = 0
        for i in range(x):
            if part[i] == a:
                r += 1
        part[x:x] = [a] * n
        return r

    def bwt(self):
        """The full BWT = concatenation of the six partitions."""
        out = []
        for b in range(NSYM):
            out.extend(self.B[b])
        return out

    def runs(self):
        """Run-length view of the BWT: list of (symbol, length)."""
        out = []
        for c in self.bwt():
            if out and out[-1][0] == c:
                out[-1][1] += 1
            else:
                out.append([c, 1])
        return [(c, l) for c, l in out]

    # --- single-string insertion (mr_insert1, mrope.c:42-68) ---

    def insert1(self, s):
        """Insert one string; s is the *reversed* sequence, no terminator."""
        is_srt = self.so != SO_IO
        is_comp = self.so == SO_RCLO
        n_sent = sum(self.part_counts(b)[0] for b in range(NSYM))
        u = n_sent
        l = 0 if is_srt else u
        b = 0
        for p in s:
            if l != u:
                tl, tu = self.rank2a(b, l, u)
                if is_comp and p != 5:
                    for a in range(4, p, -1):
                        l += tu[a] - tl[a]
                    l += tu[0] - tl[0]
                else:
                    for a in range(p):
                        l += tu[a] - tl[a]
                self.insert_run(b, l, p, 1)
                cnt = sum(self.part_counts(bb)[p] for bb in range(b))
                l = cnt + tl[p]
                u = cnt + tu[p]
            else:
                l = self.insert_run(b, l, p, 1)
                l += sum(self.part_counts(bb)[p] for bb in range(b))
                u = l
            b = p
        return self.insert_run(b, l, 0, 1)

    # --- multi-string BCR insertion (mr_insert_multi, mrope.c:258-345) ---

    def _insert_multi_aux(self, b, states):
        """One bucket-round: insert each state's next symbol into partition b,
        grouped by identical interval (mr_insert_multi_aux, mrope.c:184-233)."""
        is_comp = self.so == SO_RCLO
        m = len(states)
        for st in states:
            st.c = st.next_sym()
        beg = 0
        for k in range(1, m + 1):
            if k != m and states[k].u == states[k - 1].u:
                continue
            group = states[beg:k]
            l, u = group[0].l, group[0].u
            if l == u and len(group) == 1:
                st = group[0]
                st.l = st.u = self.insert_run(b, l, st.c, 1)
                beg = k
                continue
            if l == u:
                tl = [0] * NSYM
                tu = [0] * NSYM
            else:
                tl, tu = self.rank2a(b, l, u)
            cnt = [0] * NSYM
            for st in group:
                cnt[st.c] += 1
            if cnt[0]:
                self.insert_run(b, l, 0, cnt[0])
            x = l + cnt[0] + (tu[0] - tl[0])
            order = (4, 3, 2, 1) if is_comp else (1, 2, 3, 4)
            for s in order:
                size = tu[s] - tl[s]
                if cnt[s]:
                    tl[s] = self.insert_run(b, x, s, cnt[s])
                    tu[s] = tl[s] + size
                x += cnt[s] + size
            if cnt[5]:
                size = tu[5] - tl[5]
                tl[5] = self.insert_run(b, x, 5, cnt[5])
                tu[5] = tl[5] + size
            for st in group:
                st.l, st.u = tl[st.c], tu[st.c]
            beg = k

    def insert_multi(self, strs):
        """Insert a batch of strings (each the reversed sequence, no
        terminator), column by column (mr_insert_multi, mrope.c:258-345)."""
        is_srt = self.so != SO_IO
        n_sent = sum(self.part_counts(b)[0] for b in range(NSYM))
        states = [_Str(s) for s in strs]
        for k, st in enumerate(states):
            if is_srt:
                st.l, st.u = 0, n_sent
            else:
                st.l = st.u = n_sent + k
        self._insert_multi_aux(0, states)  # first column = last read symbols

        active = states
        while active:
            buckets = [[] for _ in range(NSYM)]
            for st in active:  # stable counting sort by last inserted symbol
                buckets[st.c].append(st)
            # bucket 0 = strings whose sentinel went in last round: finished.
            for b in range(1, NSYM):
                if buckets[b]:
                    self._insert_multi_aux(b, buckets[b])
            active = [st for b in range(1, NSYM) for st in buckets[b]]
            if not active:
                break
            # rebase local ranks by cumulative counts of lower partitions
            # (mrope.c:332-340)
            ac = [0] * NSYM
            for b in range(1, NSYM):
                pc = self.part_counts(b - 1)
                for a in range(NSYM):
                    ac[a] += pc[a]
                for st in buckets[b]:
                    st.l += ac[st.c]
                    st.u += ac[st.c]
