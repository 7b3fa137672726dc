"""Overlap (-m / --matrix) and existence (-x / --existence) commands.

Mirrors /root/reference/src/overlap.cc:607-1079: reads one or two
repertoire sets, logs per-repertoire tables, warns about exact
duplicates, finds all matching sequence pairs under the distance spec,
accumulates duplicate-count-weighted scores into a
[repertoires1 x repertoires2] matrix (matrix mode) or
[sequences1 x repertoires2] matrix (existence mode), applies
Morisita-Horn / Jaccard post-processing, and writes the matrix,
3-column, and pairs outputs.

The matching itself runs on the TPU grid engine (ops/engine.py); score
accumulation happens on host in float64 in the reference's
single-threaded emission order (seed-major, variant order), making
outputs byte-identical.
"""

from __future__ import annotations

import math
from typing import IO, Optional

import numpy as np

from ..config import Options
from ..constants import MAXDIFF_HASH, SCORE_RATIO
from ..core.db import GeneTables, SeqDB, repertoire_stats
from ..core.exact import count_duplicates
from ..core.score import fmt, pair_scores
from ..core.variant_order import sort_pairs_reference_order
from ..io.airr import read_db
from ..utils.progress import Logger, fatal


def _repertoire_table(
    db: SeqDB, stats, order: np.ndarray, logger: Logger
) -> None:
    """Per-set repertoire listing (overlap.cc:657-697)."""
    reps = db.repertoire_count
    sum_size = int(stats.size.sum())
    sum_count = int(stats.count.sum())
    w1 = max(1, 1 + int(math.floor(math.log10(reps))) if reps else 1)
    w2 = max(9, 1 + int(math.floor(math.log10(sum_size))) if sum_size else 9)
    w3 = max(5, 1 + int(math.floor(math.log10(sum_count))) if sum_count else 5)

    logger.write("Repertoires in set:\n")
    logger.write(
        "%*s %*s %*s %s\n" % (w1, "#", w2, "Sequences", w3, "Count", "Repertoire ID")
    )
    for i in range(reps):
        s = int(order[i])
        logger.write(
            "%*u %*u %*u %s\n"
            % (
                w1,
                i + 1,
                w2,
                int(stats.size[s]),
                w3,
                int(stats.count[s]),
                db.repertoire_ids[s],
            )
        )
    logger.write("\n")


def _write_pairs_header(opt: Options, pairsfile: IO[str]) -> None:
    # overlap.cc:908-925
    pairsfile.write(
        "#repertoire_id_1\tsequence_id_1\tduplicate_count_1\t"
        f"v_call_1\tj_call_1\t{opt.seq_header}_1"
    )
    for name in opt.keep_columns_names:
        pairsfile.write(f"\t{name}_1")
    pairsfile.write(
        "\trepertoire_id_2\tsequence_id_2\tduplicate_count_2\t"
        f"v_call_2\tj_call_2\t{opt.seq_header}_2"
    )
    for name in opt.keep_columns_names:
        pairsfile.write(f"\t{name}_2")
    if opt.distance:
        pairsfile.write("\tdistance")
    pairsfile.write("\n")


def _write_pairs(
    opt: Options,
    pairsfile: IO[str],
    d1: SeqDB,
    d2: SeqDB,
    idx1: np.ndarray,
    idx2: np.ndarray,
    dist: np.ndarray,
) -> None:
    # overlap.cc:455-507. Field strings are built once per distinct
    # sequence and pairs stream out in chunked joins — the naive
    # per-pair loop was ~15 Python ops/pair.
    keep = bool(opt.keep_columns_names)

    def blobs(db, idxs) -> dict:
        out = {}
        for a in np.unique(idxs):
            a = int(a)
            parts = [
                db.repertoire_ids[db.rep_no[a]],
                db.sequence_id_str(a),
                str(int(db.counts[a])),
                db.v_name(a),
                db.j_name(a),
                db.sequence_str(a),
            ]
            if keep:
                parts.append(db.keep_str(a))
            out[a] = "\t".join(parts)
        return out

    b1 = blobs(d1, idx1)
    b2 = blobs(d2, idx2)
    chunk = 1 << 20
    for s0 in range(0, len(idx1), chunk):
        i1 = idx1[s0 : s0 + chunk]
        i2 = idx2[s0 : s0 + chunk]
        if opt.distance:
            dd = dist[s0 : s0 + chunk]
            pairsfile.write(
                "".join(
                    f"{b1[int(a)]}\t{b2[int(b)]}\t{int(x)}\n"
                    for a, b, x in zip(i1, i2, dd)
                )
            )
        else:
            pairsfile.write(
                "".join(
                    f"{b1[int(a)]}\t{b2[int(b)]}\n"
                    for a, b in zip(i1, i2)
                )
            )


def overlap(
    opt: Options,
    logger: Logger,
    outfile: IO[str],
    pairsfile: Optional[IO[str]] = None,
) -> None:
    from ..ops.engine import MatchSpec, _PhaseTimer, find_pairs

    tm = _PhaseTimer()
    tm.mark()
    genes = GeneTables()

    # ---- set 1 (overlap.cc:614-703) ----
    # COMPAIRR_INPUT_SHARD=k/n makes this process read only the k-th
    # line-aligned chunk of set 1 — the per-host input sharding of a
    # multi-host run (partial matrices merge by repertoire id; see
    # scripts/multihost_demo.py and parallel/mesh.initialize_distributed)
    import os as _os

    shard = None
    shard_env = _os.environ.get("COMPAIRR_INPUT_SHARD")
    if shard_env:
        k, n = shard_env.split("/")
        shard = (int(k), int(n))

    logger.write("Immune receptor repertoire set 1\n\n")
    d1 = read_db(
        opt.input1, opt, genes, logger, opt.existence, "1", shard=shard
    )
    logger.write("\n")

    tm.lap("read1")
    stats1 = repertoire_stats(d1)
    order1 = d1.repertoire_order()
    _repertoire_table(d1, stats1, order1, logger)

    if opt.existence and d1.repertoire_count > 1:
        fatal(
            "Multiple repertoires are not allowed in the first file "
            "specified on the command line with the -x or --existence "
            "command."
        )

    # ---- set 2 (overlap.cc:705-825) ----
    logger.write("Immune receptor repertoire set 2\n\n")
    if opt.input2 and opt.input2 != opt.input1:
        d2 = read_db(opt.input2, opt, genes, logger, False, "2")
        logger.write("\n")
        stats2 = repertoire_stats(d2)
        order2 = d2.repertoire_order()
        if d2.repertoire_count > 0:
            _repertoire_table(d2, stats2, order2, logger)
        else:
            fatal("Repertoire set missing repertoire_id.")
        same_set = False
    else:
        d2 = d1
        logger.write("Set 2 is identical to set 1\n")
        logger.write("\n")
        stats2 = stats1
        order2 = order1
        if d2.repertoire_count == 0:
            fatal("Repertoire set is missing repertoire_id.")
        same_set = True

    tm.lap("read2")
    logger.write(f"Unique V genes:    {len(genes.v_names)}\n")
    logger.write(f"Unique J genes:    {len(genes.j_names)}\n")

    r1 = d1.repertoire_count
    r2 = d2.repertoire_count
    n1 = d1.n

    spec = MatchSpec(
        differences=opt.differences,
        indels=opt.indels,
        ignore_genes=opt.ignore_genes,
    )
    # start the (async) device uploads now so they overlap the
    # host-side duplicate check below — tens of seconds at 24M rows.
    # COMPAIRR_ENGINE=dense never consumes the sparse prefetch (and an
    # indel prefetch would compute a full find_pairs nobody joins,
    # contending with the dense kernels for the same chip) — skip it.
    use_dense = _os.environ.get("COMPAIRR_ENGINE", "").lower() == "dense"
    if use_dense and opt.score_int == SCORE_RATIO:
        # ratio sums are not covered by the dense f32 exactness guard
        # (engine._plan_exact_chunks skips non-integer score modes), so
        # dense ratio output would silently drift from the reference —
        # route it back to the byte-exact sparse path instead.
        logger.write(
            "Warning: COMPAIRR_ENGINE=dense does not support the ratio "
            "score exactly; using the default engine\n"
        )
        use_dense = False
    if not use_dense:
        from ..ops.engine import prefetch_find_pairs

        prefetch_find_pairs(
            d1, d2, spec,
            want_dist=pairsfile is not None and opt.distance,
        )
    tm.lap("prefetch")

    # ---- duplicate warnings (overlap.cc:838-874) ----
    # at d=0 the match join needs the same (sequence, genes) grouping
    # the warnings refine — compute it once here, reuse it in find_pairs
    exact_groups = None
    if opt.differences == 0:
        from ..ops.engine import exact_match_groups

        exact_groups = exact_match_groups(d1, d2, spec)
    # asymmetric d=1 runs (existence queries): the variant-join union
    # grouping computed here serves double duty — the big set's group
    # ids refine into its duplicate count below, and find_pairs reuses
    # the whole structure, eliminating one full grouping pass over the
    # big set (the reference detects duplicates inside the same
    # hash_insert that builds its match table, overlap.cc:579-605)
    vj_prep = None
    if not same_set and opt.differences > 0:
        from ..ops.engine import variant_join_route

        if variant_join_route(d1, d2, spec):
            from ..ops.sparse_host import prepare_variant_join

            vj_prep = prepare_variant_join(d1, d2, spec)
    if opt.differences <= MAXDIFF_HASH:
        logger.progress_init("Computing hashes: ", d1.n)
        logger.progress_update(d1.n)
        logger.progress_done()
        from ..core.exact import count_refined_groups

        if not same_set:
            logger.progress_init("Check duplicates: ", d1.n)
            if vj_prep is not None and not vj_prep.small_is_1:
                if vj_prep.big_distinct is not None:
                    dup1 = d1.n - vj_prep.big_distinct
                else:
                    dup1 = d1.n - count_refined_groups(
                        vj_prep.gb, d1.rep_no
                    )
            else:
                dup1 = count_duplicates(
                    d1,
                    include_genes=not opt.ignore_genes,
                    match_groups=(
                        exact_groups[0] if exact_groups is not None else None
                    ),
                    progress=logger.progress_update,
                )
            logger.progress_update(d1.n)
            logger.progress_done()
            if dup1 > 0:
                logger.write(
                    f"Warning: {dup1} duplicates detected in repertoire "
                    "set 1\n"
                )
            logger.progress_init("Computing hashes: ", d2.n)
            logger.progress_update(d2.n)
            logger.progress_done()
        logger.progress_init("Hashing sequences:", d2.n)
        if vj_prep is not None and vj_prep.small_is_1:
            if vj_prep.big_distinct is not None:
                dup2 = d2.n - vj_prep.big_distinct
            else:
                dup2 = d2.n - count_refined_groups(vj_prep.gb, d2.rep_no)
        else:
            dup2 = count_duplicates(
                d2,
                include_genes=not opt.ignore_genes,
                match_groups=(
                    exact_groups[1] if exact_groups is not None else None
                ),
                progress=logger.progress_update,
            )
        logger.progress_update(d2.n)
        logger.progress_done()
        if dup2 > 0:
            logger.write(
                f"Warning: {dup2} duplicates detected in repertoire set 2\n"
            )

    # approximate matching never reads the parse-time row hashes
    # (pigeonhole piece FNVs are computed fresh; the tile engine works
    # on packed residues) — drop them before the matching phase
    if opt.differences > 0 and vj_prep is None:
        d1.drop_row_hash()
        if d2 is not d1:
            d2.drop_row_hash()

    # ---- analysis ----
    if pairsfile is not None:
        _write_pairs_header(opt, pairsfile)

    # COMPAIRR_ENGINE=dense routes matrix runs through the dense f32
    # throughput engine as a product surface: one device -> dense_matrix
    # (an XLA scan over the tile worklist), several -> shard_map + psum
    # over the device mesh (parallel/mesh.dense_matrix_sharded). Integer
    # score modes stay exact under the f32 guard (_plan_exact_chunks);
    # ratio scores are f32-rounded here — the sparse default remains
    # the byte-exact path. Pairs files and existence mode need the
    # matched pair list and stay on the sparse path by construction.
    if use_dense and (
        not opt.matrix or pairsfile is not None or opt.no_matrix
    ):
        fatal(
            "COMPAIRR_ENGINE=dense supports only matrix (-m) runs "
            "without a pairs file"
        )

    matrix: Optional[np.ndarray] = None
    if use_dense:
        from ..ops.engine import _sparse_devices, dense_matrix

        devs = _sparse_devices()
        if len(devs) > 1:
            from ..parallel.mesh import dense_matrix_sharded

            logger.progress_init("Analysing:        ", 1)
            matrix = dense_matrix_sharded(
                d1, d2, spec, opt.score_int, opt.ignore_counts,
                devices=devs,
            )
            logger.progress_update(1)
            logger.progress_done()
        else:
            matrix = dense_matrix(
                d1, d2, spec, opt.score_int, opt.ignore_counts,
                logger, "Analysing:        ",
            )
    else:
        tm.lap("dup_phase")
        idx1, idx2, dist = find_pairs(
            d1, d2, spec, logger, "Analysing:        ",
            exact_groups=exact_groups, vj_prep=vj_prep,
            want_dist=pairsfile is not None and opt.distance,
        )

        # reference single-thread emission order (seed-major, variant
        # order) is required for the pairs file and whenever float64
        # accumulation is order-sensitive. Integer-valued scores
        # (product, min, max, MH, -f; mean is dyadic) sum exactly in
        # f64 while the largest possible cell stays below 2^53, making
        # the matrix independent of emission order — the sort (a 7-key
        # lexsort over every matched pair) is skipped then.
        if opt.ignore_counts:
            max_term = 1.0
        elif opt.score_int == SCORE_RATIO:
            max_term = None  # a/b sums are order-sensitive
        else:
            c1max = float(d1.counts.max()) if d1.n else 0.0
            c2max = float(d2.counts.max()) if d2.n else 0.0
            # mean terms are half-integers (spacing 0.5, exact below
            # 2^52); covered by the 2^52 threshold plus the mean term's
            # own bound, which can exceed c1max*c2max when a count is 0
            max_term = max(c1max * c2max, (c1max + c2max) / 2)
        order_free = (
            max_term is not None
            and max_term * float(max(len(idx1), 1)) < float(2**52)
        )
        if pairsfile is not None or not order_free:
            if opt.differences <= MAXDIFF_HASH:
                lmax = max(d1.longest, d2.longest, 1)
                d1.repad(lmax)
                d2.repad(lmax)
                perm = sort_pairs_reference_order(
                    d1.seqs, d1.lengths, d2.seqs, d2.lengths, idx1, idx2
                )
            else:
                # d>2 brute force emits per seed in set-2 index order
                # (process_trad, overlap.cc:286-359)
                perm = np.lexsort((idx2, idx1))
            idx1, idx2 = idx1[perm], idx2[perm]
            if dist is not None:
                dist = dist[perm]

        tm.lap("find_pairs")
        scores = pair_scores(
            d1.counts[idx1], d2.counts[idx2], opt.score_int,
            opt.ignore_counts,
        )

        if not opt.no_matrix:
            if opt.matrix:
                matrix = np.zeros((r1, r2), dtype=np.float64)
                np.add.at(
                    matrix, (d1.rep_no[idx1], d2.rep_no[idx2]), scores
                )
            else:
                matrix = np.zeros((n1, r2), dtype=np.float64)
                np.add.at(matrix, (idx1, d2.rep_no[idx2]), scores)

        if pairsfile is not None:
            _write_pairs(opt, pairsfile, d1, d2, idx1, idx2, dist)

    tm.lap("accumulate")
    # ---- write results (overlap.cc:944-1039) ----
    if not opt.no_matrix:
        assert matrix is not None
        from ..core.score import matrix_values
        from ..io.native import write_matrix_native, write_threecol_native

        vals = matrix_values(
            matrix, opt.score_int, opt.matrix,
            stats1.count, stats1.sq_count, stats2.count, stats2.sq_count,
        )
        o2 = np.asarray(order2, dtype=np.int64)
        col_ids = [d2.repertoire_ids[int(t)] for t in o2]
        if opt.matrix:
            o1 = np.asarray(order1, dtype=np.int64)
            out_vals = vals[o1][:, o2]
            row_labels = [d1.repertoire_ids[int(s)] for s in o1]
        else:
            out_vals = vals[:, o2]
            row_labels = [d1.sequence_id_str(i) for i in range(n1)]
        total = out_vals.shape[0] * out_vals.shape[1]
        logger.progress_init("Writing results:  ", total)

        if opt.alternative:
            header = (
                "#repertoire_id_1\trepertoire_id_2\tmatches\n"
                if opt.matrix
                else "#sequence_id_1\trepertoire_id_2\tmatches\n"
            )
            if not write_threecol_native(
                outfile, out_vals, row_labels, col_ids, header
            ):
                outfile.write(header)
                for i, label in enumerate(row_labels):
                    for jj in range(out_vals.shape[1]):
                        outfile.write(
                            f"{label}\t{col_ids[jj]}\t"
                            f"{fmt(out_vals[i, jj])}\n"
                        )
        else:
            header = "#" + "".join("\t" + c for c in col_ids) + "\n"
            if not write_matrix_native(
                outfile, out_vals, row_labels, header
            ):
                outfile.write(header)
                for i, label in enumerate(row_labels):
                    row = [label]
                    row.extend(
                        fmt(out_vals[i, jj])
                        for jj in range(out_vals.shape[1])
                    )
                    outfile.write("\t".join(row) + "\n")
        logger.progress_update(total)
        logger.progress_done()
    else:
        logger.progress_init("Writing results:  ", 1)
        logger.progress_done()

    tm.lap("write")
    tm.report("overlap phases")
    logger.write("\n")
