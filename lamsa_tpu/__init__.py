"""lamsa_tpu — an accelerator-native long-read split aligner (JAX, run
on NVIDIA GPUs; the CPU engine is the reference and test engine).

A from-scratch reimplementation of the capabilities of yangao07/LAMSA
(Liu & Gao et al., Bioinformatics 2017), designed for batched device
execution:

  * approximate-match seeding against an on-device k-mer/pigeonhole index
    (replacing the reference's external GEM mapper subprocess,
    SURVEY.md section 2 L3),
  * sparse-DP seed chaining into split-alignment skeletons with SV-event
    classification (reference: split_mapping.c-style chainer, SURVEY.md L4),
  * banded affine-gap Smith-Waterman gap filling as a batched XLA row
    scan with the traceback walked on the device (reference: klib
    ksw.c SSE2 kernel, SURVEY.md L5 / section 3.4),
  * SAM output with split records linked by SA:Z tags (SURVEY.md L6).

Host-level parallelism is data parallelism over reads across a
``jax.sharding.Mesh`` (the reference used pthreads over reads,
SURVEY.md section 2b); host-bound byte work (FASTQ parsing, traceback,
SAM formatting) has native C++ implementations under ``lamsa_tpu/native``.

NOTE ON CITATIONS: ``/root/reference`` was an empty mount in every build
session (see SURVEY.md section 0), so reference citations in this package
point at SURVEY.md sections / BASELINE.json lines rather than C file:line.
"""

__version__ = "0.1.0"

from lamsa_tpu.config import AlignConfig, ScoreParams, preset  # noqa: F401
