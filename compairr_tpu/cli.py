"""Command-line driver.

Replicates the reference CLI surface (/root/reference/src/compairr.cc):
the same 24 options, the same mutual-exclusion and validity checks with
identical fatal messages, the same banner / option echo / log
structure, and dispatch to the overlap/existence, cluster, and
deduplicate commands.
"""

from __future__ import annotations

import getopt
import sys
from typing import IO, Optional

from . import PROG_BRIEF, PROG_CMD, PROG_NAME, __version__
from .config import Options
from .constants import MAX_THREADS, SCORE_DESCR, SCORE_JACCARD, SCORE_MH, SCORE_OPTIONS
from .utils.progress import Logger, fatal

SHORT_OPTS = "acd:efghik:l:mno:p:s:t:uvxz"

LONG_OPTS = [
    "alternative",
    "cdr3",
    "cluster",
    "differences=",
    "distance",
    "ignore-empty",
    "ignore-counts",
    "ignore-genes",
    "help",
    "indels",
    "keep-columns=",
    "log=",
    "matrix",
    "nucleotides",
    "no-matrix",
    "output=",
    "pairs=",
    "score=",
    "summands=",
    "threads=",
    "ignore-unknown",
    "version",
    "existence",
    "deduplicate",
]

# long name -> short letter (None = long-only), compairr.cc:331-358
LONG_TO_SHORT = {
    "alternative": "a",
    "cdr3": None,
    "cluster": "c",
    "differences": "d",
    "distance": None,
    "ignore-empty": "e",
    "ignore-counts": "f",
    "ignore-genes": "g",
    "help": "h",
    "indels": "i",
    "keep-columns": "k",
    "log": "l",
    "matrix": "m",
    "nucleotides": "n",
    "no-matrix": None,
    "output": "o",
    "pairs": "p",
    "score": "s",
    "summands": "s",
    "threads": "t",
    "ignore-unknown": "u",
    "version": "v",
    "existence": "x",
    "deduplicate": "z",
}

SHORT_TO_LONG = {
    "a": "alternative",
    "c": "cluster",
    "d": "differences",
    "e": "ignore-empty",
    "f": "ignore-counts",
    "g": "ignore-genes",
    "h": "help",
    "i": "indels",
    "k": "keep-columns",
    "l": "log",
    "m": "matrix",
    "n": "nucleotides",
    "o": "output",
    "p": "pairs",
    "s": "score",
    "t": "threads",
    "u": "ignore-unknown",
    "v": "version",
    "x": "existence",
    "z": "deduplicate",
}


def show_header(f: IO[str]) -> None:
    f.write(f"{PROG_NAME} {__version__} - {PROG_BRIEF}\n")
    f.write("https://github.com/uio-bmi/compairr (reference semantics)\n")
    f.write("\n")


def args_usage(f: IO[str]) -> None:
    f.write(f"Usage: {PROG_CMD} [OPTIONS] TSVFILE1 [TSVFILE2]\n")
    f.write("\n")
    f.write("Commands:\n")
    f.write(" -h, --help                  display this help and exit\n")
    f.write(" -v, --version               display version information\n")
    f.write(" -m, --matrix                compute overlap matrix between two sets\n")
    f.write(" -x, --existence             check existence of sequences in repertoires\n")
    f.write(" -c, --cluster               cluster sequences in one repertoire\n")
    f.write(" -z, --deduplicate           deduplicate sequences in repertoires\n")
    f.write("\n")
    f.write("General options:\n")
    f.write(" -d, --differences INTEGER   number of differences accepted (0*)\n")
    f.write(" -i, --indels                allow insertions or deletions when d=1\n")
    f.write(" -f, --ignore-counts         ignore duplicate_count information\n")
    f.write(" -g, --ignore-genes          ignore V and J gene information\n")
    f.write(" -n, --nucleotides           compare nucleotides, not amino acids\n")
    f.write(" -s, --score STRING          MH, Jaccard, product*, ratio, min, max, or mean\n")
    f.write(" -t, --threads INTEGER       number of threads to use (1*-256)\n")
    f.write(" -u, --ignore-unknown        ignore sequences with unknown symbols\n")
    f.write(" -e, --ignore-empty          ignore empty sequences\n")
    f.write("\n")
    f.write("Input/output options:\n")
    f.write(" -a, --alternative           output results in three-column format, not matrix\n")
    f.write("     --cdr3                  use the cdr3(_aa) column instead of junction(_aa)\n")
    f.write("     --distance              include sequence distance in pairs file\n")
    f.write(" -k, --keep-columns STRING   comma-separated columns to copy to pairs file\n")
    f.write(" -l, --log FILENAME          log to file (stderr*)\n")
    f.write(" -o, --output FILENAME       output results to file (stdout*)\n")
    f.write("     --no-matrix             do not keep or output any matrix\n")
    f.write(" -p, --pairs FILENAME        output matching pairs to file (none*)\n")
    f.write("\n")
    f.write("                             * default value\n")
    f.write("\n")


def _args_long(value: str, option: str) -> int:
    s = value.strip()
    body = s[1:] if s[:1] in "+-" else s
    if not body.isdigit():
        sys.stderr.write(f"\nInvalid numeric argument for option {option}\n")
        raise SystemExit(1)
    return int(s)


def parse_keep_columns(spec: str) -> Optional[tuple[str, ...]]:
    """compairr.cc:114-173: comma-separated [A-Za-z0-9_]+ names."""
    names: list[str] = []
    for part in spec.split(","):
        if not part:
            return None
        for ch in part:
            if not (ch.isascii() and (ch.isalnum() or ch == "_")):
                return None
        names.append(part)
    return tuple(names)


def args_init(argv: list[str]) -> Options:
    try:
        pairs, rest = getopt.gnu_getopt(argv, SHORT_OPTS, LONG_OPTS)
    except getopt.GetoptError as e:
        sys.stderr.write(f"{PROG_CMD}: {e}\n")
        show_header(sys.stderr)
        args_usage(sys.stderr)
        raise SystemExit(1)

    kw: dict = {}
    used: set[str] = set()

    def mark(short: Optional[str], longname: str) -> None:
        # duplicate-option detection (compairr.cc:401-423)
        if short is None:
            return
        if short in used:
            sys.stderr.write(
                f"Error: Option -{short} or --{longname} specified more "
                f"than once.\n"
            )
            raise SystemExit(1)
        used.add(short)

    for optname, value in pairs:
        if optname.startswith("--"):
            longname = optname[2:]
            short = LONG_TO_SHORT[longname]
        else:
            short = optname[1:]
            longname = SHORT_TO_LONG[short]
        mark(short, longname)

        if short == "a":
            kw["alternative"] = True
        elif short == "c":
            kw["cluster"] = True
        elif short == "d":
            kw["differences"] = _args_long(value, "-d or --differences")
        elif short == "e":
            kw["ignore_empty"] = True
        elif short == "f":
            kw["ignore_counts"] = True
        elif short == "g":
            kw["ignore_genes"] = True
        elif short == "h":
            kw["help"] = True
        elif short == "i":
            kw["indels"] = True
        elif short == "k":
            kw["keep_columns"] = value
        elif short == "l":
            kw["log"] = value
        elif short == "m":
            kw["matrix"] = True
        elif short == "n":
            kw["nucleotides"] = True
        elif short == "o":
            kw["output"] = value
        elif short == "p":
            kw["pairs"] = value
        elif short == "s":
            kw["score_string"] = value
        elif short == "t":
            kw["threads"] = _args_long(value, "-t or --threads")
        elif short == "u":
            kw["ignore_unknown"] = True
        elif short == "v":
            kw["version"] = True
        elif short == "x":
            kw["existence"] = True
        elif short == "z":
            kw["deduplicate"] = True
        elif longname == "cdr3":
            kw["cdr3"] = True
        elif longname == "distance":
            kw["distance"] = True
        elif longname == "no-matrix":
            kw["no_matrix"] = True

    opt = Options(**kw)

    # command / argument-count validation (compairr.cc:561-611)
    cmd_count = (
        opt.help
        + opt.version
        + opt.matrix
        + opt.cluster
        + opt.existence
        + opt.deduplicate
    )
    if cmd_count == 0:
        fatal(
            "Please specify a command (--help, --version, --matrix, "
            "--existence, --cluster, or --deduplicate)"
        )
    if cmd_count > 1:
        fatal(
            "Please specify just one command (--help, --version, "
            "--matrix, --existence, --cluster, or --deduplicate)"
        )

    input1: Optional[str] = None
    input2: Optional[str] = None
    if opt.help or opt.version:
        if rest:
            fatal("Incorrect number of arguments")
    elif opt.matrix:
        if len(rest) == 2:
            input1, input2 = rest
        elif len(rest) == 1:
            input1 = rest[0]
        else:
            fatal(
                "Incorrect number of arguments. One or two input files "
                "must be specified."
            )
    elif opt.existence:
        if len(rest) == 2:
            input1, input2 = rest
        else:
            fatal(
                "Incorrect number of arguments. Two input files must be "
                "specified."
            )
    elif opt.cluster or opt.deduplicate:
        if len(rest) == 1:
            input1 = rest[0]
        else:
            fatal(
                "Incorrect number of arguments. One input file must be "
                "specified."
            )
    opt = opt.with_(input1=input1, input2=input2)

    if opt.deduplicate:
        if opt.differences != 0:
            fatal("Option -d or --differences must be 0 for deduplication.")
        if opt.indels:
            fatal("Option -i or --indels is not allowed for deduplication.")

    if opt.keep_columns is not None:
        if opt.pairs is None:
            fatal("Option --keep-columns only allowed with --pairs options.")
        names = parse_keep_columns(opt.keep_columns)
        if names is None:
            fatal(
                "Illegal list of columns with --keep-columns option. It "
                "must be a comma-separated list of column names. Allowed "
                "symbols: A-Z, a-z, _, and 0-9."
            )
        opt = opt.with_(keep_columns_names=names)

    if opt.threads < 1 or opt.threads > MAX_THREADS:
        fatal(
            "Illegal number of threads specified with -t or --threads, "
            f"must be in the range 1 to {MAX_THREADS}."
        )

    if opt.differences < 0:
        fatal(
            "Differences specified with -d or -differences cannot be "
            "negative."
        )

    if opt.indels and opt.differences != 1:
        fatal("Indels are only allowed when d=1")

    if opt.cluster:
        if opt.pairs is not None:
            fatal("Option -p or --pairs is not allowed with -c or --cluster")
        if opt.alternative:
            fatal(
                "Option -a or --alternative is not allowed with -c or "
                "--cluster"
            )
        if opt.score_string is not None:
            fatal("Option -s or --score is not allowed with -c or --cluster")

    if opt.score_string is not None:
        score_int = -1
        for i, name in enumerate(SCORE_OPTIONS):
            if opt.score_string.lower() == name.lower():
                score_int = i
                break
        if score_int < 0:
            fatal(
                "Argument to -s or --score must be MH, Jaccard, product, "
                "ratio, min, max or mean"
            )
        opt = opt.with_(score_int=score_int)

    if not opt.matrix:
        if opt.score_int == SCORE_MH:
            fatal(
                "The Morisita-Horn index is only allowed when computing "
                "repertoire overlap"
            )
        if opt.score_int == SCORE_JACCARD:
            fatal(
                "The Jaccard index is only allowed when computing "
                "repertoire overlap"
            )

    if opt.differences > 0:
        if opt.score_int == SCORE_MH:
            fatal("The Morisita-Horn index is not defined when d>0")
        if opt.score_int == SCORE_JACCARD:
            fatal("The Jaccard index is not defined when d>0")

    return opt


def args_show(opt: Options, logger: Logger) -> None:
    f = logger
    if opt.matrix:
        f.write("Command:           Overlap (-m)\n")
    if opt.cluster:
        f.write("Command:           Cluster (-c)\n")
    if opt.existence:
        f.write("Command:           Existence (-x)\n")
    if opt.deduplicate:
        f.write("Command:           Deduplicate (--deduplicate)\n")

    if opt.matrix:
        f.write(f"Repertoire set 1:  {opt.input1}\n")
    else:
        f.write(f"Repertoire:        {opt.input1}\n")
    if opt.matrix:
        f.write(
            "Repertoire set 2:  %s\n"
            % (opt.input2 if opt.input2 else "(same as set 1)")
        )
    if opt.existence:
        f.write(f"Repertoire set:    {opt.input2}\n")

    f.write("Nucleotides (n):   %s\n" % ("Yes" if opt.nucleotides else "No"))
    f.write(f"Differences (d):   {opt.differences}\n")
    f.write("Indels (i):        %s\n" % ("Yes" if opt.indels else "No"))
    f.write(
        "Ignore counts (f): %s\n" % ("Yes" if opt.ignore_counts else "No")
    )
    f.write("Ignore genes (g):  %s\n" % ("Yes" if opt.ignore_genes else "No"))
    f.write(
        "Ign. unknown (u):  %s\n" % ("Yes" if opt.ignore_unknown else "No")
    )
    f.write("Ignore empty (e):  %s\n" % ("Yes" if opt.ignore_empty else "No"))
    f.write("Use cdr3 column:   %s\n" % ("Yes" if opt.cdr3 else "No"))
    f.write(f"Threads (t):       {opt.threads}\n")
    if opt.no_matrix:
        f.write("Output file (o):   (none)\n")
    else:
        f.write(f"Output file (o):   {opt.output}\n")
    if opt.matrix or opt.existence:
        f.write(
            "Output format (a): %s\n"
            % ("Column" if opt.alternative else "Matrix")
        )
        f.write(f"Score (s):         {SCORE_DESCR[opt.score_int]}\n")
        f.write(
            "Pairs file (p):    %s\n" % (opt.pairs if opt.pairs else "(none)")
        )
        f.write(
            "Keep columns:      %s\n"
            % (opt.keep_columns if opt.keep_columns else "")
        )
    f.write("Log file (l):      %s\n" % (opt.log if opt.log else "(stderr)"))


def _fopen_output(filename: str) -> IO[str]:
    if filename == "-":
        return sys.stdout
    # latin-1 keeps output byte-transparent with the reference
    return open(filename, "w", encoding="latin-1", newline="")


def main(argv: Optional[list[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]

    from .utils.mem import retain_heap

    retain_heap()

    opt = args_init(argv)

    from .config import set_runtime_threads

    set_runtime_threads(opt.threads)

    # multi-host initialisation (only when COMPAIRR_DISTRIBUTED or the
    # standard JAX coordinator env vars request it): after this, all
    # chips of all hosts form the global device mesh. Gated on the env
    # so host-only runs never pay the jax import.
    import os as _os

    if _os.environ.get("COMPAIRR_DISTRIBUTED") or _os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    ):
        from .parallel.mesh import initialize_distributed

        initialize_distributed()

    # open files (compairr.cc:708-729)
    if opt.log:
        try:
            logstream = _fopen_output(opt.log)
        except OSError:
            fatal("Unable to open log file for writing.")
        logger = Logger(logstream, to_file=True)
    else:
        logger = Logger(sys.stderr, to_file=False)

    try:
        outfile = _fopen_output(opt.output)
    except OSError:
        fatal("Unable to open output file for writing.")

    pairsfile: Optional[IO[str]] = None
    if opt.pairs:
        try:
            pairsfile = _fopen_output(opt.pairs)
        except OSError:
            fatal("Unable to open pairs file for writing.")

    if opt.version or opt.help:
        show_header(logger.f)
        if opt.help:
            args_usage(sys.stderr)
        return 0

    show_header(logger.f)
    logger.show_time("Start time:        ")
    args_show(opt, logger)
    logger.write("\n")

    import contextlib
    import os

    # tracing/profiling (the reference's analogue is `make PROFILE=1`
    # + gprof, src/Makefile:33-36; here: a JAX profiler trace)
    profile_dir = os.environ.get("COMPAIRR_PROFILE")
    if profile_dir:
        import jax

        trace_ctx = jax.profiler.trace(profile_dir)
    else:
        trace_ctx = contextlib.nullcontext()

    with trace_ctx:
        if opt.matrix or opt.existence:
            from .modes.overlap import overlap

            overlap(opt, logger, outfile, pairsfile)
        elif opt.deduplicate:
            from .modes.dedup import dedup

            dedup(opt, logger, outfile)
        else:
            from .modes.cluster import cluster

            cluster(opt, logger, outfile)

    logger.show_time("End time:          ")

    if pairsfile is not None:
        pairsfile.close()
    if outfile is not sys.stdout:
        outfile.close()
    if opt.log and logger.f is not sys.stderr:
        logger.f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
