"""Engine ops: scalar math, RNG, dynamics, contacts, substep, CUDA engine."""
