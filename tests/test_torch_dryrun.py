"""The port's sLDA dry-run reports (`repro_torch.launch.dryrun`) against
the reference's (`repro.launch.dryrun`'s `slda_plan_report`,
`slda_serve_report` and `slda_elastic_report`) for the same arguments
and the same corpus: placement, rounds, checkpointing, the plans'
schedules and launches, the supervisor's policy and the service's slot
layout are equal, and so is the executor (on the CPU over several
buckets the staircase executor in both); the backend fields (the
reference's Pallas route, the port's CUDA or plain route) are not
compared.
"""
import contextlib
import io
import os

import jax
import pytest
import torch

from repro.data import make_slda_corpus as j_make
from repro_torch.convert import corpus_from_numpy
from repro_torch.launch import dryrun

# small shapes: 64 documents to 32 tokens, T 8, W 50, 4 chains
ARGV = ["--device", "cpu", "--slda-docs", "64", "--slda-maxlen", "32",
        "--slda-vocab", "50", "--slda-topics", "8", "--slda-chains", "4",
        "--slda-buckets", "3", "--slda-batch-docs", "8"]
BACKEND_FIELDS = ("backend", "device", "bucket_streams", "dispatch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module.  Importing it sets XLA_FLAGS for a
    512-device host platform; JAX's backend is started first (so this
    process keeps its devices) and the variable is put back after."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _args(extra=()):
    args = dryrun.parser().parse_args(ARGV + list(extra))
    args.slda_pallas = False            # the reference's option
    return args


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def _ref_corpus(args):
    """The corpus the reference's reports draw, for the port's."""
    c, _ = j_make(jax.random.PRNGKey(0), args.slda_docs, args.slda_vocab,
                  args.slda_topics, args.slda_maxlen,
                  phi_concentration=args.slda_phi_conc,
                  doc_len_dist="lognormal" if args.slda_len_sigma > 0
                  else "uniform", len_sigma=args.slda_len_sigma or 1.0)
    return corpus_from_numpy(c.tokens, c.mask, c.y, device="cpu")


def _plan_fields(d):
    return {k: v for k, v in d.items() if k not in BACKEND_FIELDS}


@pytest.mark.parametrize("extra", [(), ("--slda-spl", "1"),
                                   ("--slda-sampler", "sparse",
                                    "--slda-topic-cap", "4",
                                    "--slda-buckets", "0")])
def test_plan_report_equals_the_reference(jdry, extra):
    args = _args(extra)
    want = _quiet(jdry.slda_plan_report, args)
    got = _quiet(dryrun.slda_plan_report, args, corpus=_ref_corpus(args))
    for plan in ("train_plan", "predict_plan"):
        assert _plan_fields(got[plan]) == _plan_fields(want[plan]), plan
    assert got["supervisor"] == want["supervisor"]
    assert got["backend_resolution"]["route"] == "plain"
    occ = got["estimated_word_topic_occupancy"]
    assert occ["n_topics"] == args.slda_topics and 0 < occ["mean"] <= 8
    assert got["why"] and all(isinstance(w, str) for w in got["why"])


def test_serve_report_equals_the_reference(jdry):
    args = _args()
    want = _quiet(jdry.slda_serve_report, args)["service"]
    got = _quiet(dryrun.slda_serve_report, args,
                 corpus=_ref_corpus(args))["service"]
    assert _plan_fields(got) == _plan_fields(want)


@pytest.mark.parametrize("extra", [(), ("--slda-devices", "3",
                                        "--slda-chains", "7",
                                        "--slda-round-iters", "5",
                                        "--slda-ckpt-every", "2",
                                        "--slda-sync-ckpt",
                                        "--slda-elastic-deadline-s", "1.5",
                                        "--slda-speculative")])
def test_elastic_report_equals_the_reference(jdry, extra):
    args = _args(extra)
    want = _quiet(jdry.slda_elastic_report, args)
    got = _quiet(dryrun.slda_elastic_report, args)
    for k in ("chains", "devices", "placement", "rounds", "checkpointing"):
        assert got[k] == want[k], k
    assert len(got["why"]) == len(want["why"])


def test_elastic_report_refuses_a_round_that_does_not_divide():
    with pytest.raises(SystemExit, match="must divide"):
        _quiet(dryrun.slda_elastic_report,
               _args(("--slda-round-iters", "7")))


def test_cli_prints_json_and_needs_a_report():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rep = dryrun.main(ARGV + ["--slda-elastic"])
    assert '"placement"' in out.getvalue() and rep["chains"] == 4
    with pytest.raises(SystemExit), \
            contextlib.redirect_stderr(io.StringIO()):
        dryrun.main(ARGV)
