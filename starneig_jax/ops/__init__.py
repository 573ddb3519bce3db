"""Compute ops: the numerical heart of the framework.

Layer map (reference layers 3-4, SURVEY.md section 1) rebuilt in JAX:

  primitives   — reflector/rotation/2x2 scalar math (vectorized JAX)
  hessenberg   — blocked Hessenberg reduction (SEP)
  small_schur  — dense Francis QR for windows (recursion base, AED solver)
  schur        — multishift QR with AED (SEP hot path)
  reorder      — eigenvalue reordering via windowed block swaps
  eigenvectors — robust back-substitution
  qz / gep     — generalized (pencil) variants
"""
