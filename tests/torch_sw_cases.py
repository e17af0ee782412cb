"""Inputs on which the Smith-Waterman kernel is held to its plain version,
shared by ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 13.

numpy only (no JAX: the card's machine imports it). Every case is
(label, queries [Q, Lq] int8, refs [T, Lr] int8, (match, mismatch, gap));
the kernel must equal the plain version exactly on each.
"""

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_bases(rng, n: int) -> str:
    return BASES[rng.integers(0, 4, n)].tobytes().decode()


def exon_refs(rng, lens=(160, 182, 182)) -> list:
    """Three exon-like references: the last two share all but a 10-base
    segment, so reads of the two tie or nearly tie."""
    first = random_bases(rng, lens[0])
    backbone = random_bases(rng, lens[1])
    other = backbone[:60] + random_bases(rng, 10) + backbone[70:lens[2]]
    return [first, backbone, other]


def reads_from(rng, refs: list, n: int, read_len: int, n_frac: float = 0.0,
               err: float = 0.01) -> list:
    """Reads drawn from the references (substitution errors at ``err``) and
    one in three unrelated, with N at ``n_frac`` of the positions."""
    reads = []
    for i in range(n):
        ref = refs[i % len(refs)]
        if i % 3 == 2 or len(ref) < read_len:
            read = np.frombuffer(random_bases(rng, read_len).encode(), np.uint8).copy()
        else:
            start = int(rng.integers(0, len(ref) - read_len + 1))
            read = np.frombuffer(ref[start:start + read_len].encode(), np.uint8).copy()
            flips = rng.random(read_len) < err
            read[flips] = BASES[rng.integers(0, 4, int(flips.sum()))]
        if n_frac:
            read[rng.random(read_len) < n_frac] = ord("N")
        reads.append(read.tobytes().decode())
    return reads


# the register mode's edges: Lr = G*S at the longest strip of the lanes the
# chooser takes for many units (G=8 to 256 columns, 16 to 512; past 512 the
# shared mode), with reads enough for that G in either form (a packed unit
# is two reads); the first of each three in the int32 form (a positive gap,
# so its padded column is masked), the others packed
EDGES = {256: 4400, 512: 2200}


def sw_cases(seed: int = 0, main_q: int = 8192) -> list:
    """The card's cases: the main path's shape (``main_q`` reads of 150 on
    exons of 160/182/182), Q=1 with Lq=1, all-pad reads and reads with N,
    Lr not a multiple of 32, Lr=700 (the shared-memory mode), Lq > Lr,
    scores (3, -2, -3) and gap 0, and forced ties between two references.
    Then the lane groups' edges: Lr = G*S - 1, G*S and G*S + 1 where the
    chooser changes G, Lr below G, a unit count that leaves a block and a
    warp part empty (an odd read count in the packed form), a positive gap
    (the int32 form keeps the padded columns out of the best), scores past
    a byte (the int32 form) and reads with codes past 4, some int8 against
    uint8 (the packed form's warps holding them score in the int32 form)."""
    from grid_tpu_torch.ops.align import encode_seqs

    rng = np.random.default_rng(seed)
    exons = exon_refs(rng)
    refs = encode_seqs(exons)
    cases = [("main", encode_seqs(reads_from(rng, exons, main_q, 150, n_frac=0.002)), refs,
              (2, -1, -2))]
    cases.append(("q1-lq1", encode_seqs(["C"]), refs, (2, -1, -2)))
    pads = encode_seqs(reads_from(rng, exons, 64, 150, n_frac=0.05))
    pads[::4] = 4  # every fourth read all pad
    cases.append(("pad-and-n", pads, refs, (2, -1, -2)))
    odd = [random_bases(rng, 45), random_bases(rng, 97)]
    cases.append(("lr-45-97", encode_seqs(reads_from(rng, odd, 256, 40, n_frac=0.02)),
                  encode_seqs(odd), (2, -1, -2)))
    wide = [random_bases(rng, 700), random_bases(rng, 523)]
    cases.append(("lr-700-shared", encode_seqs(reads_from(rng, wide, 128, 150, n_frac=0.01)),
                  encode_seqs(wide), (2, -1, -2)))
    short = [random_bases(rng, 64), random_bases(rng, 33)]
    cases.append(("lq-gt-lr", encode_seqs(reads_from(rng, short, 128, 200)), encode_seqs(short),
                  (2, -1, -2)))
    mid = encode_seqs(reads_from(rng, exons, 512, 150, n_frac=0.01))
    cases.append(("scores-3-2-3", mid, refs, (3, -2, -3)))
    cases.append(("gap-0", mid, refs, (2, -1, 0)))
    twins = encode_seqs([exons[1], exons[1], exons[0]])  # two identical references
    cases.append(("forced-ties", encode_seqs(reads_from(rng, [exons[1]], 256, 120)), twins,
                  (2, -1, -2)))
    for edge, n_reads in EDGES.items():
        for lr in (edge - 1, edge, edge + 1):
            seqs = [random_bases(rng, lr), random_bases(rng, lr - 20)]
            reads = encode_seqs(reads_from(rng, seqs, n_reads, 60, n_frac=0.01))
            reads[5] = 4  # a read of all 4s
            cases.append((f"lr-{lr}", reads, encode_seqs(seqs),
                          (2, -1, 1) if lr == edge - 1 else (2, -1, -2)))
    tiny = [random_bases(rng, 3), "AC", random_bases(rng, 3)]
    cases.append(("lr-3-lt-g", encode_seqs(reads_from(rng, tiny, 3000, 8, n_frac=0.02)),
                  encode_seqs(tiny), (2, -1, -2)))
    cases.append(("units-ragged", encode_seqs(reads_from(rng, exons, 1001, 150, n_frac=0.01)),
                  refs, (2, -1, -2)))
    cases.append(("gap+1", mid, refs, (2, -1, 1)))
    cases.append(("scores-300", mid, refs, (300, -100, -150)))
    alphabet = np.array([0, 1, 2, 3, 4, 5, 6, 200, 250], np.uint8)
    raw = alphabet[rng.integers(0, 9, (600, 120))]
    raw[:300] = np.where(raw[:300] > 4, 2, raw[:300])  # the first warps' reads of codes 0-4
    cases.append(("codes-past-4", raw.view(np.int8),
                  alphabet[rng.integers(0, 9, (3, 170))].view(np.int8), (2, -1, -2)))
    return cases


def acgt_pairs(seed: int = 1, n: int = 6) -> list:
    """A few (read, reference) strings of ACGT only, for the host oracle."""
    rng = np.random.default_rng(seed)
    exons = exon_refs(rng, (60, 70, 70))
    return [(r, exons[i % 3]) for i, r in enumerate(reads_from(rng, exons, n, 40))]
