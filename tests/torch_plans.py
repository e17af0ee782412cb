"""The launch plans of the cohort step's kernels by element size, as pure
functions: what ``csrc/knn_select.cu`` (``plan_of``, ``select_mode``),
``csrc/dipcn_select.cu`` (``dyn_smem_bytes``), ``csrc/phase_sweeps.cu``
(``resident_smem_bytes``), ``csrc/zprep_gram64.cu`` (``mode_blocks``,
``kSmemBytes``; with ``csrc/zprep_gram.cu``, the cross mode's launches)
and ``csrc/zprep_gram16.cu`` (``mode_tiles``, ``kSmemBytes``) compute.
``tests/test_torch_float64.py`` checks them on the CPU;
``tests/test_torch_gpu.py`` holds the kernels' own ``*_info`` answers to
them on the card.
"""

from __future__ import annotations


def _list_len(k: int) -> int:
    """knn_select's sorted list: the next power of two >= k, at least 128."""
    length = 128
    while length < k:
        length <<= 1
    return length


def _key_align(itemsize: int) -> int:
    """Keys a 16-byte line holds, at least 4 (``key_align`` of both
    selection kernels): the slices' and the shared keys' rounding."""
    return max(4, 16 // itemsize)


def knn_select_plan(w: int, k: int, itemsize: int) -> dict:
    """``knn_select``'s plan for rows of ``w`` columns of ``itemsize`` bytes
    (2: bfloat16, 4: float32, 8: float64) at this ``k``: the shared mode's
    blocks a row (the least power of two up to 8 that keeps a slice within
    8,192 columns) and columns a block (a multiple of 8 in bfloat16, of 4
    else), its dynamic shared memory a block (the slice's keys, the list of
    4-byte bfloat16 or 8-byte float32 composite entries or 16-byte float64
    pairs, the 16-bit gather buffer), the wide mode's (the list and an
    int32 gather buffer), the largest cluster the shared mode takes (8 in
    bfloat16 and float32, 1 in float64), the largest k and the widest row
    (bfloat16's 17-bit column field)."""
    length = _list_len(k)
    entry = {2: 4, 4: 8, 8: 16}[itemsize]
    align = _key_align(itemsize)
    blocks = 1
    while blocks < 8 and -(-w // blocks) > 8192:
        blocks <<= 1
    cols = w if blocks == 1 else -(-(-(-w // blocks)) // align) * align
    return {"cluster_blocks": blocks, "slice": cols,
            "shared_smem_bytes": -(-cols // align) * align * itemsize + length * entry
            + 2 * length * 2,
            "wide_smem_bytes": length * entry + max(length, 2048) * 4,
            "max_shared_cluster": 1 if itemsize == 8 else 8,
            "max_k": 8192 if itemsize == 8 else 16384,
            "max_w": 1 << 17 if itemsize == 2 else None}


def knn_select_mode_of(w: int, k: int, itemsize: int, smem: int) -> str | None:
    """The mode ``select_mode`` picks where a block may take ``smem`` bytes
    of dynamic shared memory (and every cluster that fits can be
    scheduled): "resident" or "cluster" where the shared mode's cluster is
    one it takes and its slice fits, else "wide" where the list fits, else
    None."""
    plan = knn_select_plan(w, k, itemsize)
    if not 1 <= k <= min(w, plan["max_k"]) or w > (plan["max_w"] or w):
        return None
    if plan["cluster_blocks"] <= plan["max_shared_cluster"] and plan["shared_smem_bytes"] <= smem:
        return "resident" if plan["cluster_blocks"] == 1 else "cluster"
    return "wide" if plan["wide_smem_bytes"] <= smem else None


def dipcn_select_smem_bytes(w: int, k: int, itemsize: int) -> int:
    """The resident mode's dynamic shared memory a block, in either form
    (binary, or multi-weight, whose step 5m compacts the same list in
    place) and value type: the row's keys of ``itemsize`` bytes (2:
    bfloat16, rounded to 8 keys; 4, 8: to 4), its usable bits and a 16-bit
    list of min(k, w) columns."""
    align = _key_align(itemsize)
    return (-(-w // align) * align * itemsize + -(-w // 32) * 4 + -(-min(k, w) // 8) * 8 * 2)


def phase_sweeps_smem_bytes(n: int, k: int, itemsize: int) -> int:
    """The resident mode's dynamic shared memory a block at N samples and K
    slots of ``itemsize``-byte values: the two value buffers of C = 8
    slices of 2 chunk values, chunk = ceil(N / C), and the block's lists
    (an int32 index, a weight and a validity byte a slot)."""
    chunk = -(-n // 8)
    return 4 * itemsize * 8 * chunk + 2 * (5 + itemsize) * chunk * k


# csrc/zprep_gram64.cu: 128x128 tiles, 16 R columns a stage, a ring of 4
# stages of both operands (dense 128-byte rows), 8 consumer warps and a
# producer warpgroup
GRAM64_TILE, GRAM64_K_TILE, GRAM64_STAGES, GRAM64_CONSUMERS = 128, 16, 4, 256
H100_SMS, H100_SMEM = 132, 232_448


def zprep_gram64_plan(n: int, rows: int, mode: str) -> dict:
    """The FP64 Gram's launch at ``n`` rows in ``mode``: "triangle" (the
    upper-triangle tiles), "split" (the diagonal tiles), "panel" (``rows``
    rows: its row tiles times the column tiles, the row tiles of one column
    tile neighbours) or "cross" (a block of ``rows`` rows by a block of
    ``n``: the same tiles, one launch whatever the blocks' offsets, no
    mirror). One block a tile and one block an
    SM (64 float64 accumulators a consumer thread), so ``waves`` is blocks
    over 132 SMs;
    the dynamic shared memory holds the ring and, after it, the epilogue's
    [128][129] float64 tile, with 1 KB to align the ring for the 128-byte
    swizzle. ``flops_per_l2_byte`` is what a tile multiplies per operand
    byte it reads from L2 (a diagonal tile reads one operand: twice that)."""
    t = GRAM64_TILE
    tiles = -(-n // t)
    blocks = {"triangle": tiles * (tiles + 1) // 2, "split": tiles,
              "panel": -(-rows // t) * tiles, "cross": -(-rows // t) * tiles}[mode]
    ring, epilogue = GRAM64_STAGES * 2 * t * GRAM64_K_TILE * 8, t * (t + 1) * 8
    return {"tile": t, "k_tile": GRAM64_K_TILE, "stages": GRAM64_STAGES,
            "threads": GRAM64_CONSUMERS + 128, "smem_bytes": max(ring, epilogue) + 1024,
            "ring_bytes": ring, "epilogue_bytes": epilogue,
            "blocks": blocks, "blocks_per_sm": 1, "waves": blocks / H100_SMS,
            "accumulators": t * t // GRAM64_CONSUMERS,
            "flops_per_l2_byte": 2 * t * t / ((t + t) * 8)}


def zprep_gram64_l2_bytes(n: int, rows: int, mode: str, r_pad: int) -> int:
    """The bytes the FP64 Gram's tiles read from L2 in one call: R_pad
    float64 of both operands' 128 rows a tile, one operand a diagonal tile
    (every tile of the split; in the triangle and in a panel that starts on
    a tile, the tiles whose row and column tiles coincide)."""
    plan = zprep_gram64_plan(n, rows, mode)
    operand = plan["tile"] * r_pad * 8
    tiles = -(-n // plan["tile"])
    diag = {"triangle": tiles, "split": tiles, "panel": -(-rows // plan["tile"]),
            "cross": 0}[mode]
    return (2 * (plan["blocks"] - diag) + diag) * operand


# csrc/zprep_gram16.cu: tiles of 128 rows by 256 columns, 64-column stages
# in a ring of 4, two staged 64-column boxes of G, two consumer warpgroups
# and a producer warpgroup, one block an SM walking the tiles
GRAM16_ROWS, GRAM16_COLS, GRAM16_K_TILE, GRAM16_STAGES, GRAM16_EPI_BOXES = 128, 256, 64, 4, 2


def zprep_gram16_plan(n: int, rows: int, mode: str, sms: int = H100_SMS) -> dict:
    """The bf16 Gram's launch at ``n`` rows in ``mode`` (``mode_tiles``):
    the triangle's row tile i takes the tiles from column 128 i in steps of
    256, a panel of ``rows`` rows its row tiles times the 256-column tiles,
    and so does a cross block of ``rows`` rows by one of ``n``.
    Its dynamic shared memory holds the ring (48 KB a stage: 128 rows of A,
    256 of B) and the staged boxes of G (16 KB each), with 1 KB to align
    the ring; one block an SM, and the grid is one block an SM or one a
    tile where there are fewer."""
    if mode in ("panel", "cross"):
        tiles = -(-rows // GRAM16_ROWS) * -(-n // GRAM16_COLS)
    else:
        tiles = sum(-(-(n - row0) // GRAM16_COLS) for row0 in range(0, n, GRAM16_ROWS))
    stage = (GRAM16_ROWS + GRAM16_COLS) * GRAM16_K_TILE * 2
    return {"tile_rows": GRAM16_ROWS, "tile_cols": GRAM16_COLS, "k_tile": GRAM16_K_TILE,
            "stages": GRAM16_STAGES, "threads": 384, "epilogue_boxes": GRAM16_EPI_BOXES,
            "smem_bytes": GRAM16_STAGES * stage + GRAM16_EPI_BOXES * GRAM16_ROWS * 64 * 2 + 1024,
            "tiles": tiles, "blocks_per_sm": 1, "grid": min(tiles, sms)}
