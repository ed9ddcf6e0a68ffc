"""The one correction the JAX package's ``Estimator`` is run with wherever
the port is held against it.

``factors/marginalization.slide_window`` clears ``lm_valid`` of the
landmarks anchored at the marginalized node but keeps their observations
at the other nodes; the estimator then frees those slots and hands them to
new features, which would carry the dead point's observations into their
rounds. The port's ``Estimator._marginalize_oldest`` clears those rows
(``obs_valid`` off, ``obs_uv`` and ``obs_vel`` zero) before it frees the
slots. ``clear_dead_rows`` gives a JAX ``Estimator`` the same step, after
its own ``_marginalize_oldest``; the JAX package itself is not edited.
"""

import numpy as np


def clear_dead_rows(est):
    """Wrap ``est._marginalize_oldest`` (a JAX ``Estimator``) so that the
    rows of the slots that die with the anchor are cleared, and count them
    in ``est._dead_cleared`` as the port does."""
    import jax.numpy as jnp

    real = est._marginalize_oldest
    est._dead_cleared = {"observations": 0, "slots": 0}

    def marginalize_oldest():
        lm_ref, lm_valid = np.asarray(est.window.lm_ref), np.asarray(est.window.lm_valid)
        dead = [s for s in est.lm_slot.values() if lm_ref[s] == 0 and lm_valid[s]]
        real()
        if not dead:
            return
        w = est.window
        mask = np.zeros(lm_valid.shape[0], bool)
        mask[dead] = True
        est._dead_cleared["observations"] += int(np.asarray(w.obs_valid)[dead].sum())
        est._dead_cleared["slots"] += len(dead)
        m = jnp.asarray(mask)[:, None]
        est.window = w._replace(obs_valid=w.obs_valid & ~m,
                                obs_uv=jnp.where(m[..., None], 0.0, w.obs_uv),
                                obs_vel=jnp.where(m[..., None], 0.0, w.obs_vel))

    est._marginalize_oldest = marginalize_oldest
    return est
