"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

The JAX package is the reference: :func:`jax_pipeline` runs its encoder
stages on the CPU, where each Pallas kernel is replaced by the JAX
package's own XLA oracle (``_sig_tokens_xla``, the scatter-add pack,
``_pack_ref_bits``) and the step bases are pair-aligned, as in the port,
so the port's intermediates compare one to one.
Inputs are numpy arrays; results come back as numpy arrays.
"""

from __future__ import annotations

import numpy as np

STATS_KEYS = (
    "planes", "planes_max", "nS", "nRef", "root_cnt", "root_base",
    "planes_base", "step_base", "step_end", "inj_pos", "refpfx", "carry_in",
    "refrun_val", "refrun_ok", "valid", "carry_end", "T", "order", "nS_ck",
    "nZ_ck", "base_sched", "nS_sched", "cin_sched", "valid_sched")


def to_np(x):
    """torch tensor or JAX array -> numpy (stream words as uint32)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def jax_pipeline(img: np.ndarray, monkeypatch) -> dict:
    import jax
    import jax.numpy as jnp

    from dwt_tpu.codec import encoder as je
    from dwt_tpu.geometry import compute_pyramid
    from dwt_tpu.hilbert import padded_layout

    # On the CPU the JAX package takes its XLA paths; make sure of it.
    monkeypatch.setattr(je, "_use_pallas", lambda: False)
    h, w, c = img.shape
    pyr = compute_pyramid(w, h)
    perm, valid, _ = padded_layout(pyr, je.ALIGN)
    lin, stats = jax.jit(lambda x, p: je._transform_and_stats(
        x, pyr, c, c == 1, p, engine=False))(jnp.asarray(img),
                                             jnp.asarray(perm))
    T = int(stats["T"])
    padded_T = je._bucket(T)

    def stage2(lin, stats):
        tv, tr, tf, orders = je._stage2_tokens(lin, stats, pyr, c, padded_T)
        words_tok = je._pack_bits(lin, stats, tv, tr, tf, orders, pyr, c,
                                  padded_T, je._stream_words(pyr, c, padded_T),
                                  xla_pack=True)[0]
        words, parts, wild, ends = je._stage2_emit(
            lin, stats, tv, tr, tf, orders, pyr, c, padded_T, xla_pack=True)
        segs = je._Segs(pyr)
        com = je._unit_common(stats, segs, pyr, c)
        meta_a, _ = je._kernel_a_meta(stats, segs, com, padded_T)
        refstart = je._codeword_contribs(stats, tv, tr, tf, orders,
                                         padded_T)[3]
        meta_b = je._kernel_b_meta(stats, segs, com, refstart, pyr, padded_T,
                                   words.shape[0])
        zp, sgn = je._sig_tokens_xla(lin, stats, pyr, c, padded_T)
        return dict(tv=tv, tr=tr, tf=tf, orders=orders, words_tok=words_tok,
                    words=words, bits_parts=parts, wild=wild,
                    layer_ends=ends, meta_a=meta_a, meta_b=meta_b, zp=zp,
                    sgn=sgn, **{f"com_{k}": v for k, v in com.items()})

    out = {k: to_np(v) for k, v in jax.jit(stage2)(lin, stats).items()}
    total = je._check_stream_bits(je._total_bits_host(out["bits_parts"]))
    nbytes = (total + 7) // 8
    out.update(
        lin=np.where(valid[None, :], to_np(lin), 0),  # pads 0, as the kernel
        stats={k: to_np(stats[k]) for k in STATS_KEYS},
        padded_T=padded_T,
        payload=out["words"][: (nbytes + 3) // 4].tobytes()[:nbytes])
    return out
