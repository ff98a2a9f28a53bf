"""Command-line driver with the reference's exact flag surface
(reference: ebwt2InDel.cpp:76-103 help text, 1677-1823 main)."""

from __future__ import annotations

import getopt
import os
import sys

from .models import pipeline
from .utils.config import (
    Config, K_DEF, K_LEFT_DEF, K_RIGHT_DEF, MAX_GAP_DEF, MAX_SNVS_DEF,
    MCOV_OUT_DEF,
)

OPTSTRING = "h1:2:v:L:R:m:g:k:t:o:d:c:q:"  # cpp:1684


def help_text() -> str:
    return (
        "ebwt2InDel [options]\n"
        "Options:\n"
        "-h          Print this help.\n"
        "-1 <arg>    Input eBWT file (A,C,G,T,#) of first reads set (REQUIRED).\n"
        "-2 <arg>    Input eBWT file (A,C,G,T,#) of second reads set. If not specified, perform genotyping of first reads set.\n"
        "            If specified, find differences (SNPs/indels) between the two reads sets.\n"
        "-d <arg>    Input Document Array. If option -2 is not specified, this file specifies which characters from the input bwt\n"
        "            belong to the first (0) and which from the second (1) individual. Format: ASCII file filled with '0' and '1'.\n"
        "-o <arg>    Output .snp file (REQUIRED).\n"
        f"-L <arg>    Length of left-context, SNP included. Default: {K_LEFT_DEF}.\n"
        f"-R <arg>    Length of right context, SNP excluded. Default: {K_RIGHT_DEF}.\n"
        f"-k <arg>    Minimum LCP required in clusters. Default: {K_DEF}.\n"
        f"-g <arg>    Maximum allowed gap length in indel. Default: {MAX_GAP_DEF}. If 0, indels are disabled.\n"
        f"-v <arg>    Maximum number of non-isolated SNPs in left-contexts (excluding cntral SNP/indel). Default: {MAX_SNVS_DEF}.\n"
        f"-m <arg>    Minimum coverage of output events. Default: {MCOV_OUT_DEF}.\n"
        "-c <arg>    Discard events with low-complexity right-context.  Here, low-complexity means that the context starts with a \n"
        "            run of <arg> equal characters. Default: length of right context (-R), minus 10.\n"
        "-q          Maximum number of allowed variants per genomic position in each sample. If 0, there is no limit. Default: 0.\n"
        f"-t <arg>    ASCII value of terminator character. Default: {ord('#')} (#).\n"
        "\n"
        "\nTo run ebwt2InDel, you must first build the extended Burrows-Wheeler"
        " Transform of the input sequences.\n\n"
        "Output format: A fasta file with DNA fragments containing the variations.\n"
    )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(help_text())
        return 0

    try:
        opts, _ = getopt.getopt(argv, OPTSTRING)
    except getopt.GetoptError:
        print(help_text())
        return 1

    cfg = Config()
    for flag, val in opts:
        if flag == "-h":
            print(help_text())
            return 0
        elif flag == "-1":
            cfg.input1 = val
        elif flag == "-o":
            cfg.output = val
        elif flag == "-2":
            cfg.input2 = val
        elif flag == "-d":
            cfg.input_da = val
        elif flag == "-m":
            cfg.mcov_out = int(val)
        elif flag == "-k":
            cfg.K = int(val)
        elif flag == "-g":
            cfg.max_gap = int(val)
        elif flag == "-L":
            cfg.k_left = int(val)
        elif flag == "-R":
            cfg.k_right = int(val)
        elif flag == "-v":
            cfg.max_snvs = int(val)
        elif flag == "-t":
            cfg.term = int(val)
        elif flag == "-c":
            cfg.complexity = int(val)
        elif flag == "-q":
            cfg.max_variants_per_position = int(val)

    if not cfg.input1 or not cfg.output:
        print(help_text())
        return 1
    if not os.path.isfile(cfg.input1):
        print(f"Error: could not find file {cfg.input1}\n")
        print(help_text())
        return 1
    if cfg.input2 and not os.path.isfile(cfg.input2):
        print(f"Error: could not find file {cfg.input2}\n")
        print(help_text())
        return 1
    if cfg.input2 and cfg.input_da:
        print("Error: Document array (-d) can only be used with one input "
              "BWT file (-1)\n")
        print(help_text())
        return 1

    print("This is ebwt2InDel (JAX accelerator build).")
    if cfg.input2:
        print(f"Running on two samples. Input eBWT files : {cfg.input1} "
              f"and {cfg.input2}")
    elif cfg.input_da:
        print(f"Running on one sample with input Document array. Input "
              f"eBWT/DA files : {cfg.input1} and {cfg.input_da}")
    else:
        print(f"Running on one sample (genotyping). Input eBWT file : "
              f"{cfg.input1}")

    r = cfg.resolved()
    print(f"Left-extending eBWT ranges by {r.k_left} bases.")
    print(f"Right context length: {r.k_right} bases.")
    print(f"Complexity filter: {r.complexity}")
    print(f"Storing output events to file {cfg.output}")
    print(f"Minimum coverage of output events: {r.mcov_out}")
    if cfg.max_variants_per_position > 0:
        print(f"Maximum number of variants per genomic position per sample: "
              f"{cfg.max_variants_per_position}")
    else:
        print("Maximum number of variants per genomic position per sample: "
              "unlimited.")
    print()

    # EBWT_MESH=<n> routes execution through the sharded pipeline over an
    # n-device 'pos' mesh (multi-chip path; byte-identical output). An env
    # switch, not a flag: the optstring stays reference-identical.
    # EBWT_COORD (+ EBWT_NPROCS/EBWT_PROCID) additionally joins a
    # multi-host jax.distributed run; the mesh then spans every process's
    # devices and only process 0 writes the output file.
    n_mesh = int(os.environ.get("EBWT_MESH", "0") or 0)

    try:
        from .parallel import launch

        if launch.distributed_requested():
            launch.init_from_env()
            import jax

            n_mesh = n_mesh or len(jax.devices())
            cfg = launch.redirect_output(cfg)
        if n_mesh > 1:
            from .parallel import pipeline as ppipe
            from .parallel import shard

            mesh = shard.make_mesh(n_mesh)
            if cfg.input2:
                ppipe.run_two_datasets_sharded(cfg, mesh)
            elif cfg.input_da:
                ppipe.run_two_datasets_da_sharded(cfg, mesh)
            else:
                ppipe.run_one_dataset_sharded(cfg, mesh)
        elif cfg.input2:
            pipeline.run_two_datasets(cfg)
        elif cfg.input_da:
            pipeline.run_two_datasets_da(cfg)
        else:
            pipeline.run_one_dataset(cfg)
    except ValueError as e:
        # e.g. forbidden character in the input BWT — the reference prints the
        # message and exits 1 (dna_string.hpp:90-96)
        print(e)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
