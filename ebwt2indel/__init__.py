"""ebwt2indel — a JAX/XLA framework for reference-free
SNP/indel discovery on the extended Burrows-Wheeler Transform of read collections.

Built from scratch with the capabilities of nicolaprezza/ebwt2InDel (see SURVEY.md):
the cache-line rank structure (reference: internal/dna_string.hpp) becomes batched
block-gather + popcount ops over bit-packed DNA in device memory; the sequential
Weiner-link suffix-tree DFS (reference: ebwt2InDel.cpp:555-831) becomes
level-synchronous interval-extension wavefronts; positional clustering, consensus
extraction and KisSNP2 `.snp` emission (reference: ebwt2InDel.cpp:835-1674) are
reproduced byte-for-byte in all three input modes.
"""

__version__ = "0.1.0"
