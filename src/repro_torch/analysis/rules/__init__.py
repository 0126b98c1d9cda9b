"""The port's contract-linter ruleset.  Importing it registers every rule
family into ``repro_torch.analysis.framework.RULES``:

=======  ==================================================================
family   contract it mechanizes
=======  ==================================================================
TRNG     every random draw takes a seeded ``torch.Generator``
TSYNC    the fused episode and the serving hot path make no host sync
TDET     bit-reproducible corpus and cache; f32 evaluators, f64 oracles;
         deterministic accumulation on trained paths
TEXP     ``__all__`` and the PEP 562 lazy-export tables agree
TJIT     conditions are data: no condition-keyed build cache
TANA     the noqa mechanism itself stays honest
=======  ==================================================================

The reference's DOC rules are not carried: they already read the whole
repo's README and DESIGN, the port's sections included.
"""
from . import det, exports, jit, meta, rng, sync  # noqa: F401 (registers)

from ..framework import RULES

__all__ = ["RULES"]
