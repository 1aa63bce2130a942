"""AOT export of the port (advoc_tpu_torch.infer.export) against the JAX package's.

The counterparts of tests/test_export.py's eight tests, on the CPU: the
artifact reproduces the live port Vocoder (bit for bit: the exported
program runs the same aten operators on the same weights), pads and crops
to the exported shapes, picks the tightest, writes JAX's manifest keys,
refuses an unaligned bucket, fails when no artifact fits and records its
platform. Beside them: a phase_impl="kernel" artifact records the
registered G-L operator (its CPU implementation is the plain version) and
is refused without allow_custom_calls; the registered operators pass
torch.library.opcheck; and vocode_cli's --aot_export then --aot round trip.
The live port Vocoder is held to the JAX Vocoder by tests/test_torch_vocoder.py
(the same tiny generator, gl_iters and mel); here the artifact is held to it.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advoc_tpu.data import loader
from advoc_tpu.ops import spectral as jsp
from advoc_tpu.ops.reference import DEFAULT_PARAMS as P
from advoc_tpu_torch.infer import Vocoder
from advoc_tpu_torch.infer import vocode_cli
from advoc_tpu_torch.infer.export import ExportedVocoder, export_vocoder
from advoc_tpu_torch.models.advoc import AdvocConfig, AdvocGenerator
from advoc_tpu_torch.ops.kernels import griffin_lim as tgl
from advoc_tpu_torch.ops.kernels import registered
from advoc_tpu_torch.ops.reference import AudioParams


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs (the suite's workers
    share the cores), restored after it: set at import, the count would
    change every module's sums in each worker that collects this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mel():
    wav = jnp.asarray(loader.synthetic_speech(0, 22050 * 2))
    return np.asarray(jsp.waveform_to_r9y9_melspec(wav, P))  # (173, 80)


@pytest.fixture(scope="module")
def gen():
    """tests/test_export.py's tiny float32 generator, seeded weights."""
    g = AdvocGenerator(AdvocConfig(n_frames=64, width=8, depth=4, dtype="float32"))
    g.reset_parameters(torch.Generator().manual_seed(0))
    return g


@pytest.fixture(scope="module")
def tiny_voc(gen):
    return Vocoder(gen, chunk_frames=64, overlap_frames=8, gl_iters=4, device="cpu",
                   gl_precision="highest")


@pytest.fixture(scope="module")
def export_run(tmp_path_factory, tiny_voc):
    """One directory of artifacts shared by the tests that only read it,
    and the manifest export_vocoder returned."""
    out = tmp_path_factory.mktemp("aot")
    return out, export_vocoder(tiny_voc, [(1, 192), (4, 128)], out)


@pytest.fixture(scope="module")
def exported(export_run):
    return export_run[0]


class TestExportRoundTrip:
    def test_matches_live_vocoder(self, exported, mel, tiny_voc):
        served = ExportedVocoder(exported, device="cpu")
        want = tiny_voc(mel)
        got = served(mel)
        assert got.shape == want.shape == (mel.shape[0] * P.hop_length,)
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_heuristic_only_export(self, tmp_path, mel):
        voc = Vocoder(gl_iters=8, chunk_frames=64, device="cpu")
        export_vocoder(voc, [(1, 192)], tmp_path)
        served = ExportedVocoder(tmp_path, device="cpu")
        torch.testing.assert_close(served(mel), voc(mel), rtol=0, atol=0)

    def test_pads_batch_and_time_to_exported_shape(self, exported, tiny_voc):
        served = ExportedVocoder(exported, device="cpu")
        mels = np.stack([
            np.asarray(jsp.waveform_to_r9y9_melspec(
                jnp.asarray(loader.synthetic_speech(s, 100 * P.hop_length)), P))[:100]
            for s in (1, 2)
        ])  # (2, 100, 80): padded to (4, 128, 80)
        got = served(mels)
        assert got.shape == (2, 100 * P.hop_length)
        torch.testing.assert_close(got, tiny_voc(mels), rtol=0, atol=1e-5)

    def test_picks_tightest_bucket(self, tmp_path, exported):
        """The pick reads the manifest alone: four entries written by hand
        beside the exported two."""
        man = json.loads((exported / "manifest.json").read_text())
        man["artifacts"] += [{"batch": b, "t_frames": t, "file": f"voc_b{b}_t{t}.pt2",
                              "platforms": ["cpu"]} for b, t in ((1, 64), (2, 64))]
        (tmp_path / "manifest.json").write_text(json.dumps(man))
        served = ExportedVocoder(tmp_path, device="cpu")
        assert served.shapes() == [(1, 64), (2, 64), (4, 128), (1, 192)]
        assert served._pick(1, 60) == (1, 64)
        assert served._pick(2, 64) == (2, 64)
        assert served._pick(1, 100) == (4, 128)
        assert served._pick(1, 150) == (1, 192)


class TestExportContract:
    def test_manifest_contents(self, export_run):
        exported, m = export_run
        on_disk = json.loads((exported / "manifest.json").read_text())
        assert on_disk == m
        assert set(m) == {"format", "sample_rate", "n_mels", "hop_length", "chunk_frames",
                          "phase_method", "gl_iters", "artifacts"}
        assert m["format"] == 1 and m["sample_rate"] == P.sample_rate
        assert m["hop_length"] == P.hop_length and m["chunk_frames"] == 64
        assert [a["batch"] for a in m["artifacts"]] == [1, 4]
        assert set(m["artifacts"][0]) == {"batch", "t_frames", "file", "platforms"}
        assert all((exported / a["file"]).exists() for a in m["artifacts"])

    def test_rejects_unaligned_bucket(self, tmp_path, tiny_voc):
        with pytest.raises(ValueError, match="bucket-aligned"):
            export_vocoder(tiny_voc, [(1, 100)], tmp_path)

    def test_no_fitting_artifact_raises(self, exported):
        served = ExportedVocoder(exported, device="cpu")
        with pytest.raises(ValueError, match="no exported artifact"):
            served(np.zeros((8, 64, P.n_mels), np.float32))

    def test_platform_recorded(self, exported, tiny_voc):
        m = json.loads((exported / "manifest.json").read_text())
        assert [e["platforms"] for e in m["artifacts"]] == [["cpu"], ["cpu"]]
        with pytest.raises(ValueError, match="traced on"):
            export_vocoder(tiny_voc, [(1, 64)], exported / "x", platforms=["cuda"])

    def test_other_platform_raises_on_load(self, tmp_path, exported, mel):
        """An artifact recorded for the card, served on the CPU: the load
        raises before it reads the file."""
        man = json.loads((exported / "manifest.json").read_text())
        man["artifacts"][0]["platforms"] = ["cuda"]
        (tmp_path / "manifest.json").write_text(json.dumps(man))
        with pytest.raises(RuntimeError, match="exported for"):
            ExportedVocoder(tmp_path, device="cpu")(mel[:150])

    def test_default_device_is_the_card(self, exported, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ExportedVocoder(exported)


class TestKernelArtifacts:
    def test_kernel_artifact_needs_allow_custom_calls(self, tmp_path, gen, mel):
        """phase_impl="kernel" records advoc::griffin_lim, whose CPU
        implementation is the plain version: refused without
        allow_custom_calls, and equal to the live call with it."""
        voc = Vocoder(gen, chunk_frames=64, overlap_frames=8, gl_iters=4, device="cpu",
                      phase_impl="kernel")
        with pytest.raises(ValueError, match="allow_custom_calls"):
            export_vocoder(voc, [(1, 192)], tmp_path)
        export_vocoder(voc, [(1, 192)], tmp_path, allow_custom_calls=True)
        program = torch.export.load(tmp_path / "voc_b1_t192.pt2")
        assert registered.recorded(program.graph_module) == ["advoc::griffin_lim"]
        torch.testing.assert_close(ExportedVocoder(tmp_path, device="cpu")(mel), voc(mel),
                                   rtol=0, atol=0)

    def test_profiler_records_nothing_in_the_graph(self, tmp_path, tiny_voc):
        """Exported under a profiler, the program's spans stay out of the
        graph and out of the profiler's trace while traced: only the eager
        call that builds the constants first records them, once each."""
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            export_vocoder(tiny_voc, [(1, 128)], tmp_path)
        program = torch.export.load(tmp_path / "voc_b1_t128.pt2")
        targets = [str(n.target) for n in program.graph_module.graph.nodes
                   if n.op == "call_function"]
        assert targets and not [t for t in targets if "profiler" in t or "record" in t]
        names = [e.name() for e in prof.profiler.kineto_results.events()]
        assert [names.count(n) for n in ("advoc.estimate", "advoc.unet", "advoc.gl")] == [1, 1, 1]

    def test_xla_artifact_records_no_kernel(self, exported):
        program = torch.export.load(exported / "voc_b4_t128.pt2")
        assert registered.recorded(program.graph_module) == []

    def test_eager_calls_launch_no_operator(self, mel):
        """Eager wrappers run as before: on a CPU tensor the plain version
        itself, not the operator (so it stays differentiable)."""
        mag = torch.rand((1, 16, 512), requires_grad=True)
        tgl.griffin_lim_kernel(mag, 1, 0.99).sum().backward()
        assert mag.grad is not None

    @pytest.mark.parametrize("op", ["griffin_lim", "fused_melspec", "packed_up",
                                    "group_norm_act", "conv_bias_act"])
    def test_registered_operators_pass_opcheck(self, op):
        g = torch.Generator().manual_seed(0)
        p = registered.params_list(AudioParams())
        if op == "griffin_lim":
            mag = torch.rand((2, 8, 512), generator=g)
            phi = torch.rand((2, 8, 512), generator=g)
            cases = [(mag, None, None, 2, 0.99, "split", p),
                     (mag, torch.cos(phi), torch.sin(phi), 1, 0.99, "float32", p)]
            fn, plain = registered.griffin_lim_op, (
                lambda m, c, s, n, mo, ld, pp: tgl.griffin_lim_plain(
                    m, n, mo, None if c is None else (c, s), loop_dtype=ld))
        elif op == "fused_melspec":
            from advoc_tpu_torch.ops.kernels.featurizer import fused_melspec_plain

            cases = [(torch.randn((2, 4096), generator=g) * 0.1, p)]
            fn, plain = registered.fused_melspec_op, (lambda w, pp: fused_melspec_plain(w))
        elif op == "group_norm_act":
            from advoc_tpu_torch.ops.kernels.group_norm import group_norm_act_plain

            x = torch.randn((2, 16, 4, 6), generator=g).to(torch.bfloat16)
            w, b = torch.rand(16, generator=g) + 0.5, torch.randn(16, generator=g) * 0.1
            cb = torch.randn(16, generator=g)
            cases = [(x.contiguous(memory_format=torch.channels_last), w, b, 8, "leaky_relu"),
                     (x, w, b, 4, "relu"),
                     (x.contiguous(memory_format=torch.channels_last), w, b, 8, "relu", None),
                     (x.contiguous(memory_format=torch.channels_last), w, b, 8, "relu", cb),
                     (x, w, b, 4, "leaky_relu", cb)]
            fn, plain = registered.group_norm_act_op, group_norm_act_plain
        elif op == "conv_bias_act":
            from advoc_tpu_torch.ops.kernels.conv_bias_act import conv_bias_act_plain

            y = torch.randn((2, 8, 65), generator=g).to(torch.bfloat16)
            bias = (torch.randn(8, generator=g) * 0.1).to(torch.bfloat16)
            cases = [(y, bias, 0, 1, "leaky_relu", torch.float32),
                     (y[..., :64].contiguous(), bias, 0, 0, "relu", torch.bfloat16)]
            fn, plain = registered.conv_bias_act_op, conv_bias_act_plain
        else:
            from advoc_tpu_torch.ops.kernels.packed_up import packed_up_plain

            x = torch.randn((1, 4, 8, 16), generator=g).to(torch.bfloat16)
            wt, bias = torch.randn((4, 4, 16, 8), generator=g) * 0.1, torch.zeros(8)
            cases = [(x, wt, bias, 8, 1, True), (x, wt, bias, 8, 2, False)]
            fn = registered.packed_up_op
            plain = (lambda x, w, b, f, tm, st: packed_up_plain(x, w, b, f=f, tm=tm,
                                                                with_stats=st))
        def as_tuple(x):
            return x if isinstance(x, tuple) else (x,)

        for args in cases:
            torch.library.opcheck(fn, args, test_utils=("test_schema", "test_faketensor"))
            # Without stats packed_up's operator adds two empty sums: zip drops them.
            for a, b in zip(as_tuple(fn(*args)), as_tuple(plain(*args))):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


    def test_group_norm_act_records_its_layout(self):
        """The wrapper traced on the CPU is advoc::group_norm_act, whose fake
        implementation gives the output x's shape, dtype and channels-last
        strides; the program equals the plain version bit for bit."""
        from advoc_tpu_torch.ops.kernels import group_norm as tgn

        class Norm(torch.nn.Module):
            def forward(self, x):
                return tgn.group_norm_act_kernel(x, torch.linspace(0.5, 1.5, 16),
                                                 torch.zeros(16), 8, "relu")

        x = torch.randn((2, 16, 4, 6)).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        program = torch.export.export(Norm(), (x,))
        assert registered.recorded(program.graph_module) == ["advoc::group_norm_act"]
        out = next(n for n in program.graph_module.graph.nodes
                   if n.op == "call_function" and "group_norm_act" in str(n.target))
        val = out.meta["val"]
        assert (tuple(val.shape), val.dtype, val.stride()) == (x.shape, torch.bfloat16,
                                                                x.stride())
        got = program.module()(x)
        assert torch.equal(got, tgn.group_norm_act_plain(x, torch.linspace(0.5, 1.5, 16),
                                                         torch.zeros(16), 8, "relu"))
        assert got.stride() == x.stride()


class TestCli:
    def test_aot_export_then_aot_round_trips(self, tmp_path, mel, tiny_voc):
        """--aot_export writes (1, bucket) artifacts of the heuristic Vocoder
        for each input; --aot serves them with no model code, and the wavs
        equal the live CLI's."""
        np.save(tmp_path / "m.npy", np.stack([mel[:150], mel[:150]]))
        common = ["--input", str(tmp_path / "m.npy"), "--gl_iters", "2", "--device", "cpu"]
        out = vocode_cli.main([*common, "--out_dir", str(tmp_path / "unused"),
                               "--aot_export", str(tmp_path / "aot")])
        assert [(a["batch"], a["t_frames"]) for a in out["exported"]["artifacts"]] == [(1, 256)]
        vocode_cli.main([*common, "--out_dir", str(tmp_path / "served"),
                         "--aot", str(tmp_path / "aot")])
        vocode_cli.main([*common, "--out_dir", str(tmp_path / "live"), "--batch", "1"])
        for i in range(2):
            served = (tmp_path / "served" / f"m_{i}.wav").read_bytes()
            assert served == (tmp_path / "live" / f"m_{i}.wav").read_bytes()

    @pytest.mark.parametrize("extra", [["--aot_export", "y"], ["--longform"]])
    def test_aot_refuses_export_and_longform(self, tmp_path, extra):
        with pytest.raises(SystemExit):
            vocode_cli.main(["--input", "x.npy", "--out_dir", str(tmp_path), "--device", "cpu",
                             "--aot", "x", *extra])

    def test_kernel_artifact_needs_the_flag(self, tmp_path, mel):
        np.save(tmp_path / "m.npy", mel[:64])
        args = ["--input", str(tmp_path / "m.npy"), "--out_dir", str(tmp_path / "o"),
                "--gl_iters", "1", "--device", "cpu", "--phase_impl", "kernel",
                "--aot_export", str(tmp_path / "aot")]
        with pytest.raises(ValueError, match="allow_custom_calls"):
            vocode_cli.main(args)
        out = vocode_cli.main([*args, "--aot_allow_custom_calls"])
        assert out["exported"]["artifacts"][0]["t_frames"] == 256

