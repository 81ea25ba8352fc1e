"""Cubegan.infer of the port against the JAX model on the CPU: the text tower and the
generator's serving path with the fused tail stage (its plain version on the CPU),
fp32."""

import numpy as np

from ttscube_tpu.models import cubegan as jcg
from ttscube_tpu.models import hifigan as jhg
from ttscube_tpu.models import languasito as jla
from ttscube_tpu_torch.convert import load_jax_params
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.models import hifigan as thg
from ttscube_tpu_torch.models import languasito as tla
from tests.torch_parity import LANG, SMALL_HIFI, assert_close, gen_pair, lang_pair_of, t

FRAMES = 96


def test_cubegan_infer_matches_jax():
    """Equal durations, audio within 5e-5."""
    _, lparams, _, X = lang_pair_of(FRAMES)
    _, _, gparams, _ = gen_pair(SMALL_HIFI, seed=4)
    hifi = dict(SMALL_HIFI, fused_tail=True)
    jcfg = jcg.CubeganConfig(languasito=jla.LanguasitoConfig(**LANG),
                             hifigan=jhg.HifiganConfig(**hifi), hop_size=16)
    jm = jcg.Cubegan(jcfg, train=False)
    params = {"lang": lparams, "gen": gparams}
    want, aux = jm.infer(params, X, max_frames=FRAMES)
    tm = tcg.Cubegan(tcg.CubeganConfig(languasito=tla.LanguasitoConfig(**LANG),
                                       hifigan=thg.HifiganConfig(**hifi), hop_size=16))
    load_jax_params(tm, params).eval()
    got, taux = tm.infer({k: t(v).long() for k, v in X.items()}, max_frames=FRAMES)
    np.testing.assert_array_equal(taux["durations"].numpy(), np.asarray(aux["durations"]))
    assert int(taux["durations"].sum()) > 0
    assert_close("Cubegan.infer audio fp32", got, want, 5e-5)
