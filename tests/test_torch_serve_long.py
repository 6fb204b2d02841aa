"""The port's server runs a long clip in the request's own handler thread,
outside the hot batch (as ``psla_tpu/tools/serve.py`` does), so a short
request is answered while a long clip is still in flight.

The port's ``predict_long`` is replaced by one that blocks on an event;
every wait has a timeout, so a hang fails the test instead of stalling the
suite.
"""

import threading

import numpy as np
import torch

from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.models import create_model
from psla_tpu_torch.tools import serve as serve_mod
from psla_tpu_torch.tools.serve import InferenceEngine

torch.set_num_threads(2)

N_CLASS, SR, WAIT_S = 4, 16000, 60
CFG = PreprocessConfig(target_length=64)
CHUNK = CFG.fbank.buffer_length(CFG.target_length)


def test_short_request_completes_while_a_long_clip_runs(monkeypatch):
    members = [create_model("efficientnet", label_dim=N_CLASS, eff_b=0, head_num=1,
                            generator=torch.Generator().manual_seed(s)) for s in (1, 2)]
    engine = InferenceEngine(members, CFG, {i: str(i) for i in range(N_CLASS)},
                             batch_size=2, batch_window_ms=1.0, device="cpu")
    entered, release = threading.Event(), threading.Event()
    callers = []

    def blocking_predict_long(model, wav, config, device=None):
        callers.append(threading.current_thread())
        entered.set()
        if not release.wait(timeout=WAIT_S):
            raise TimeoutError("the long clip was never released")
        # member k answers k + 1 everywhere: the engine must average them
        return np.full(N_CLASS, engine.members.index(model) + 1.0, np.float32)

    monkeypatch.setattr(serve_mod, "predict_long", blocking_predict_long)
    rng = np.random.default_rng(0)
    out: dict = {}

    def ask(key, wav):
        try:
            out[key] = engine.predict(wav, SR)
        except Exception as e:  # reported by the asserts below
            out[key] = e

    long_t = threading.Thread(target=ask, args=("long", rng.uniform(-0.3, 0.3, 3 * CHUNK)
                                                .astype(np.float32)), daemon=True)
    short_wav = rng.uniform(-0.3, 0.3, CHUNK // 2).astype(np.float32)
    short_t = threading.Thread(target=ask, args=("short", short_wav), daemon=True)
    try:
        long_t.start()
        assert entered.wait(timeout=WAIT_S), "the long clip never reached predict_long"
        short_t.start()
        short_t.join(timeout=WAIT_S)
        assert not short_t.is_alive(), "the short request waited behind the long clip"
        assert long_t.is_alive() and "long" not in out
        buf = np.zeros((1, CHUNK), np.float32)
        buf[0, : short_wav.size] = short_wav
        want = engine.batch_probs(buf, np.array([short_wav.mean()], np.float32),
                                  np.array([short_wav.size], np.int32))[0]
        np.testing.assert_allclose(out["short"], want, atol=1e-6)
    finally:
        release.set()
        long_t.join(timeout=WAIT_S)
        engine.close()
    assert not long_t.is_alive()
    np.testing.assert_array_equal(out["long"], np.full(N_CLASS, 1.5, np.float32))
    # both members ran in the long request's own thread, not the batcher's
    assert callers == [long_t, long_t]
    assert engine.stats()["long_clips"] == 1 and engine.stats()["requests"] == 2
