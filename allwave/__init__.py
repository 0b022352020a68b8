"""allwave — all-pairs pairwise DNA sequence aligner on a GPU.

A from-scratch JAX/XLA framework with the capabilities of the reference
CPU tool (pangenome/allwave): all-vs-all gap-affine / two-piece-affine
global wavefront alignment with full CIGARs, MinHash ("mash")
strand-orientation detection, deterministic sparsification strategies,
and streaming PAF output.

Public API mirrors the reference library facade (lib.rs:20-26) while
the execution engine is batched and device-resident. The package never
selects a JAX platform: JAX picks the accelerator, and tests choose the
CPU with JAX_PLATFORMS=cpu.
"""

from .core.types import (
    AlignmentError,
    AlignmentMode,
    AlignmentParams,
    AlignmentResult,
    AutoSparsification,
    ConnectivitySparsification,
    NoSparsification,
    RandomSparsification,
    Sequence,
    SparsificationStrategy,
    TreeSampling,
)
from .core.cigar import cigar_bytes_to_string
from .core.paf import alignment_to_paf
from .core.scores import parse_ani_preset, parse_scores
from .orient.orientation import reverse_complement

__version__ = "0.1.0"

__all__ = [
    "AlignmentError",
    "AlignmentMode",
    "AlignmentParams",
    "AlignmentResult",
    "AutoSparsification",
    "ConnectivitySparsification",
    "NoSparsification",
    "RandomSparsification",
    "Sequence",
    "SparsificationStrategy",
    "TreeSampling",
    "alignment_to_paf",
    "cigar_bytes_to_string",
    "parse_ani_preset",
    "parse_scores",
    "process_alignments_with_callback",
    "reverse_complement",
    "__version__",
]


def process_alignments_with_callback(sequences, params, sparsification, callback):
    """Streaming all-vs-all alignment (reference: lib.rs:57-68):
    exclude_self=True, mash orientation. Lazily imports the engine so that
    light-weight users of the core API do not pay for JAX start-up."""
    from .engine.pipeline import process_alignments_with_callback as _impl

    return _impl(sequences, params, sparsification, callback)


def __getattr__(name):
    # Lazy heavyweight exports (keep `import allwave` JAX-free).
    if name in ("AllPairAligner", "AllPairIterator"):
        from .engine.pipeline import AllPairAligner

        return AllPairAligner
    if name in ("read_fasta", "iter_fasta", "write_fasta"):
        from .engine import fasta

        return getattr(fasta, name)
    if name == "align_pair":
        from .wfa.simple import align_pair

        return align_pair
    if name == "KmerSketch":
        from .sketch.minhash import KmerSketch

        return KmerSketch
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
