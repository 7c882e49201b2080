"""Shared by the zoo's parity tests: emx's variables for a flax module
without running its initialiser (eager flax init of even a tiny model
costs ~20 s of CPU here): the tree comes from jax.eval_shape of emx's
init, the values from numpy at a seed, at lecun-normal scale for
kernels, near 1 for norm scales, positive for BatchNorm variances."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from flax.traverse_util import flatten_dict, unflatten_dict


# emx's references compile with LLVM's optimisations off: the same HLO,
# the same arithmetic but for the last bits of a float32 (XLA's vectorised
# reductions), at about a fifth less compile time, which with tracing is
# most of what these tests cost on a CPU.
ref_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})


def flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def emx_variables(module, *args, seed: int = 0, **kw) -> dict:
    """{collection: flat {"A/B/kernel": float32 array}} for `module`."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args,
                                                **kw))
    rng = np.random.default_rng(seed)
    out = {}
    for coll, tree in shapes.items():
        leaves = {}
        for k, s in flatten_dict(tree, sep="/").items():
            name = k.rsplit("/", 1)[-1]
            if name == "var":
                v = rng.uniform(0.5, 2.0, s.shape)
            elif name in ("scale", "mean"):
                v = (name == "scale") + 0.2 * rng.standard_normal(s.shape)
            elif name == "unique":      # a tied kernel's weights
                v = 0.2 * rng.standard_normal(s.shape)
            elif len(s.shape) >= 2:
                v = rng.standard_normal(s.shape) / np.sqrt(
                    np.prod(s.shape[:-1]))
            else:
                v = 0.1 * rng.standard_normal(s.shape)
            leaves[k] = v.astype(np.float32)
        out[coll] = leaves
    return out


def as_emx(variables: dict) -> dict:
    """flat -> flax's nested trees of jnp arrays."""
    return {c: unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                               for k, v in t.items()})
            for c, t in variables.items()}


# The smallest Xception-trunk configs that still reach every branch: one
# entry block, one middle block, the exit flow, ASPP, three upsamplings.
XCEPTION = dict(entry_features=(8,), num_middle_blocks=1,
                exit_features=(8, 8), aspp_out=8, decoder_features=(8,))
EMBEDDER = dict(entry_features=(8,), num_middle_blocks=1, fc_features=16,
                embedding_dim=6)
# The latent autoencoder with one block of each kind (8x8 in and out).
LATENT = dict(enc_features=(8,), head_features=(8, 8), latent_dim=8,
              dec_features=(8,))
