"""Public API umbrella (reference: src/include/starneig/starneig.h).

  api.sep     — standard eigenvalue problem, single-process ("SM")
  api.gep     — generalized eigenvalue problem, single-process
  api.sep_dm  — standard EVP over a device mesh ("DM")
  api.gep_dm  — generalized EVP over a device mesh
"""

from starneig_jax.api import sep
from starneig_jax.api import gep
