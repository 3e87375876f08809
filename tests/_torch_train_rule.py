"""The rule that holds the port's training trajectory to the reference's
(``tests/test_torch_training.py`` and ``tests/test_torch_checkpoint.py``).

Both packages run the same AdamW steps from the same f32 state; the tests
hold the losses, ``grad_norm`` and ``lr`` within 1e-5 relative each step,
and :func:`hold_trajectory` holds the states ``S_0 .. S_n`` after each step,
given each side's own gradients at each state.

With step ``s`` taking ``S_{s-1}`` to ``S_s`` by the clip factor
``c_s = min(1, grad_clip / grad_norm_s)``, the sent gradient ``ghat_s``
(the gradient itself without compression), and ``Δ`` the port's value
less the reference's, every element is held to what the step's arithmetic
allows, each bound with 1e-5 of its leaf's largest |value| added for the
f32 rounding:

* the carried error: ``ghat_s`` is ``127 * bin_s`` at the leaf's largest
  element and ``|e_s| <= bin_s / 2`` on either side, so
  ``|Δe_s| <= (bin_s(port) + bin_s(ref)) / 2``, one bin;
* ``ghat_s = g_s + e_{s-1} - e_s``, so
  ``|Δ(c ghat)_s| <= d_s = c_s (|Δg_s| + |Δe_{s-1}| + |Δe_s|)``, with
  ``Δg_s`` the measured difference of the two sides' gradients;
* ``mu_s = b1 mu_{s-1} + (1 - b1) c_s ghat_s``, so
  ``|Δmu_n| <= (1 - b1) sum_s b1^(n-s) d_s``;
* ``nu_s = b2 nu_{s-1} + (1 - b2) (c_s ghat_s)^2``, so
  ``|Δnu_n| <= (1 - b2) sum_s b2^(n-s) d_s (2 |c_s ghat_s(port)| + d_s)``;
* ``p_s = p_{s-1} - lr_s u_s`` with ``u_s = mhat_s / (sqrt(nhat_s) + eps)
  + wd p_{s-1}``, so ``Δp_n = -sum_s lr_s Δu_s``: the parameters differ by
  exactly what the moments' differences explain (each ``u_s`` computed in
  f64 from that side's own states).  A wrong sign, scale or rate of the
  update fails this where the moments agree.

``c_s ghat_s`` is read off each side's moments,
``(mu_s - b1 mu_{s-1}) / (1 - b1)``.

Across the tree:

* Under compression an element whose (gradient + carried error) lands on
  a rounding boundary of its leaf's int8 grid in one framework and not in
  the other is sent one bin apart.  Such an element is *flipped* (at some
  step ``|Δ(c ghat)_s|`` exceeds half of ``c_s bin_s``); at most
  ``FLIP_CAP`` of the elements may be.  A wrong quantizer or carried error
  sends most elements apart and fails here.
* At the last state, an element is *off* where the port's parameter or
  moment lies farther than 1e-5 of the leaf's largest |value| from the
  reference's.  AdamW divides by ``sqrt(nhat)``, so an element whose
  gradient is rounding noise (its sign differing between the frameworks)
  moves its parameter by up to a whole ``lr`` either way, and a flip moves
  the element's moments.  Outside flips at most a thousandth of the
  elements may be off.  The carried errors are not counted: their scale is
  half a bin, 1/254 of the gradient's, so the gradients' own f32 drift
  moves most of them by more than 1e-5 of it; each is held to one bin.
"""
import jax
import numpy as np

from repro_torch._tree import tree_leaves

FLIP_CAP = 0.01  # of the elements (5 steps of smollm-360m .tiny() flip 0.07%)
QMAX = 127.0  # ef_compress's default 8 bits
REL = 1e-5


def port_leaves(state):
    """{"p", "mu", "nu", "e"}: a port ``TrainState``'s leaves in f64."""
    f = lambda tree: [t.double().numpy() for t in tree_leaves(tree)]  # noqa: E731
    return {"p": f(state.params), "mu": f(state.opt.mu), "nu": f(state.opt.nu),
            "e": None if state.ef_error is None else f(state.ef_error)}


def ref_leaves(jstate):
    """The same of a reference ``TrainState``."""
    f = lambda tree: [np.asarray(t, np.float64) for t in jax.tree_util.tree_leaves(tree)]  # noqa: E731
    return {"p": f(jstate.params), "mu": f(jstate.opt.mu), "nu": f(jstate.opt.nu),
            "e": None if jstate.ef_error is None else f(jstate.ef_error)}


def _scale(x):
    return max(np.abs(x).max(), 1e-30)


def hold_trajectory(port, ref, port_grads, ref_grads, grad_norms, lrs, opt_cfg):
    """Hold ``port[s]`` to ``ref[s]`` (``port_leaves``/``ref_leaves`` of
    ``S_0 .. S_n``, ``S_0`` equal in both; ``*_grads[s-1]`` each side's own
    gradient leaves at ``S_{s-1}``, ``grad_norms[s-1]`` and ``lrs[s-1]`` the
    reference's metrics of step ``s``) under the rule of the module
    docstring.  Returns what was measured: the flipped share, the off
    elements outside flips, and each bound's largest |Δ| / bound."""
    b1, b2, eps, wd = opt_cfg.b1, opt_cfg.b2, opt_cfg.eps, opt_cfg.weight_decay
    n = len(port) - 1
    compressed = ref[0]["e"] is not None
    n_leaves = len(ref[0]["p"])
    total = sum(x.size for x in ref[0]["p"])
    clip = [min(1.0, opt_cfg.grad_clip / max(g, 1e-12)) for g in grad_norms]
    worst = {"e": 0.0, "mu": 0.0, "nu": 0.0, "p": 0.0}
    flipped = [np.zeros(x.shape, bool) for x in ref[0]["p"]]
    n_off = {k: 0 for k in ("p", "mu", "nu")}

    def held(what, i, delta, bound, scale):
        bound = bound + REL * scale
        ratio = float((np.abs(delta) / bound).max())
        worst[what] = max(worst[what], ratio)
        assert ratio <= 1, (what, i, ratio)

    for i in range(n_leaves):
        de = [np.zeros_like(ref[0]["p"][i])] * (n + 1)
        if compressed:
            de = [port[s]["e"][i] - ref[s]["e"][i] for s in range(n + 1)]
        mu_b = nu_b = np.zeros_like(de[0])
        p_explained = np.zeros_like(de[0])
        for s in range(1, n + 1):
            sent = {side: (st[s]["mu"][i] - b1 * st[s - 1]["mu"][i]) / (1 - b1)
                    for side, st in (("port", port), ("ref", ref))}  # c_s ghat_s
            dg = np.abs(port_grads[s - 1][i] - ref_grads[s - 1][i])
            if compressed:
                bins = [_scale(g) / (QMAX * clip[s - 1]) for g in sent.values()]
                held("e", i, de[s], (bins[0] + bins[1]) / 2, _scale(ref[s]["e"][i]))
                flipped[i] |= np.abs(sent["port"] - sent["ref"]) > clip[s - 1] * bins[1] / 2
            d = clip[s - 1] * (dg + np.abs(de[s - 1]) + np.abs(de[s]))
            d = d + REL * _scale(sent["ref"])
            mu_b = b1 * mu_b + (1 - b1) * d
            nu_b = b2 * nu_b + (1 - b2) * d * (2 * np.abs(sent["port"]) + d)
            held("mu", i, port[s]["mu"][i] - ref[s]["mu"][i], mu_b, _scale(ref[s]["mu"][i]))
            held("nu", i, port[s]["nu"][i] - ref[s]["nu"][i], nu_b, _scale(ref[s]["nu"][i]))
            c1, c2 = 1 - b1 ** s, 1 - b2 ** s
            u = [st[s]["mu"][i] / c1 / (np.sqrt(st[s]["nu"][i] / c2) + eps) + wd * st[s - 1]["p"][i]
                 for st in (port, ref)]
            p_explained -= lrs[s - 1] * (u[0] - u[1])
            held("p", i, (port[s]["p"][i] - ref[s]["p"][i]) - p_explained, 0.0, _scale(ref[s]["p"][i]))
        for k in n_off:
            w = ref[n][k][i]
            n_off[k] += int(((np.abs(port[n][k][i] - w) > REL * _scale(w)) & ~flipped[i]).sum())
    share = sum(int(f.sum()) for f in flipped) / total
    assert share <= FLIP_CAP, ("flipped", share)
    for k, v in n_off.items():
        assert v <= total // 1000, ("off outside flips", k, v, total)
    return {"flipped": share, "off": n_off, "worst": worst}
