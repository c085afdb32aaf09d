"""CommPhase, the PhaseStack arena, shared primitives and strategy rewrites."""
