"""npge_tpu — an accelerator-native nucleotide pangenome construction engine.

Brand-new design with the capabilities of NPGe (NPG-explorer, reference:
zer0main/npge): given a set of closely related genomes, partition every genome
position into *blocks* — alignments of similar fragments across genomes and
strands — such that every position belongs to exactly one block, every
multi-fragment block meets length/identity quality criteria, and no two
neighboring blocks can be merged.

Architecture (not a port — see SURVEY.md §7):
  - ``model``    struct-of-arrays data model: GenomeArena (packed bases),
                 FragmentTable, Block/BlockSet (host-resident, numpy)
  - ``ops``      device compute: canonical k-mer scan, minimizer sampling,
                 anchor grouping (lax.sort), batched gapless group extension,
                 Pallas banded Smith-Waterman x-drop kernel, consensus
  - ``algo``     pipeline stages mirroring the reference's processors
                 (AnchorFinder, Extender, OverlapsResolver, Rest, Joiner,
                 Filter, IsPangenome, ...) as array-native functions
  - ``parallel`` jax.sharding mesh helpers; shard_map seed-extend with
                 all_gather + deterministic dedup merge
  - ``io``       FASTA / genomes.tsv / .bs blockset formats

Reference parity notes cite public-NPGe paths (e.g. ``src/model/Block.hpp``)
flagged per SURVEY.md §0: the reference mount was empty at build time, so all
citations are structural-recall tier [B]/[C], to be re-verified.
"""

__version__ = "0.1.0"

from npge_tpu.config import Config, default_config  # noqa: F401
