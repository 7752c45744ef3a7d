"""The port's host runtime against the JAX package's, case by case, on the
same inputs: the RF HAL (``tests/test_rf_hal.py`` but its AGC loop), the
file / UDP / TCP sample I/O, config, metrics, crash handler, pcap writers
and band tables (``tests/test_mac_runtime.py`` ``TestRuntime``,
``TestPcapCrash``, ``TestBandTables``, ``TestPcapWriters``), the libconfig
parser, and the native ring buffer (``tests/test_native_stream.py``) on
the port's own ``g++`` build of ``csrc/ring_buffer.cpp``. Outputs must be
equal: files byte for byte, samples and timestamps exactly, parsed
configs field for field, console metrics text for text. Also the port's
``trace``: a ``SignalDump`` round trip and a ``torch.profiler`` trace
written on the CPU.

The ring buffer is held to the data it carries, not to the JAX package's
library: that one builds with ``make`` inside ``native/``, which
``tests/test_native_stream.py`` may be doing in another worker at the
same time."""

import dataclasses
import importlib
import io
import json
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = "empower_srslte_tpu", "empower_srslte_tpu_torch"


def pair(mod: str):
    """(the JAX package's module, the port's) of a dotted module name."""
    return tuple(importlib.import_module(f"{pkg}.{mod}")
                 for pkg in (JAX_PKG, PORT_PKG))


def iq(rng, n: int) -> np.ndarray:
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


# --- RF HAL ------------------------------------------------------------------


class TestRfRegistry:
    def test_unknown_device_raises_alike(self):
        msgs = []
        for rf in pair("runtime.rf"):
            with pytest.raises(ValueError, match="unknown rf device") as e:
                rf.rf_open("does_not_exist")
            msgs.append(str(e.value).split(";")[0])
        assert msgs[0] == msgs[1]

    def test_auto_probe_opens_the_same_device(self):
        opened = []
        for rf in pair("runtime.rf"):
            class AlwaysOpens(rf.RfDevice):
                name = "zztest"

                def __init__(self, args=""):
                    super().__init__()

                def recv_with_time(self, n):
                    return np.zeros(n, np.complex64), 0

                def send_timed(self, s, t):
                    pass

            rf.register_device(AlwaysOpens)
            dev = rf.rf_open(None, "")
            assert isinstance(dev, rf.RfDevice)
            opened.append((type(dev).__name__, dev.name))
            dev.close()
        assert opened[0] == opened[1]

    def test_vtable_setters(self, tmp_path):
        got = []
        for k, rf in enumerate(pair("runtime.rf")):
            p = tmp_path / f"x{k}.bin"
            p.write_bytes(b"")
            dev = rf.rf_open("file", f"tx={p}")
            vals = (dev.set_rx_srate(11.52e6), dev.set_tx_srate(1.92e6),
                    dev.set_rx_gain(40.0), dev.set_tx_gain(10.0),
                    dev.set_rx_freq(2.68e9), dev.set_tx_freq(2.56e9))
            dev.start_rx_stream()
            vals += (dev.streaming,)
            dev.stop_rx_stream()
            vals += (dev.streaming, dev.name)
            dev.close()
            got.append(vals)
        assert got[0] == got[1]
        assert got[1][:7] == (11.52e6, 1.92e6, 40.0, 10.0, 2.68e9, 2.56e9,
                              True)


def _file_loopback(rf, path: str):
    tx = rf.FileRfDevice(f"tx={path}")
    burst = (np.arange(100) + 1j * np.arange(100)).astype(np.complex64)
    tx.send_timed(burst, timestamp=None)
    # timed TX with a gap: the device zero-fills to stay sample-accurate
    tx.send_timed(burst, timestamp=250)
    tx.close()
    rx = rf.FileRfDevice(f"rx={path}")
    return burst, [rx.recv_with_time(n) for n in (100, 150, 100)]


class TestFileRfDevice:
    def test_loopback_with_timestamps(self, tmp_path):
        paths = [str(tmp_path / f"iq{k}.bin") for k in range(2)]
        (burst, ref), (_, got) = (_file_loopback(rf, p) for rf, p in
                                  zip(pair("runtime.rf"), paths))
        assert pathlib.Path(paths[0]).read_bytes() == \
            pathlib.Path(paths[1]).read_bytes()
        for (a, ta), (b, tb) in zip(ref, got):
            assert ta == tb and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert [t for _, t in got] == [0, 100, 250]
        np.testing.assert_array_equal(got[0][0], burst)
        assert np.all(got[1][0] == 0)
        np.testing.assert_array_equal(got[2][0], burst)

    def test_rx_loops_at_eof(self, tmp_path, rng):
        data = iq(rng, 64)
        reads = []
        for k, rf in enumerate(pair("runtime.rf")):
            p = str(tmp_path / f"iq{k}.bin")
            tx = rf.FileRfDevice(f"tx={p}")
            tx.send_timed(data, None)
            tx.close()
            rx = rf.FileRfDevice(f"rx={p}")
            reads.append([rx.recv_with_time(100), rx.recv_with_time(50)])
        for (a, ta), (b, tb) in zip(*reads):
            assert ta == tb
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(reads[1][0][0],
                                      np.concatenate([data, data[:36]]))


class TestNetRfDevice:
    def test_udp_stream(self, rng):
        burst = iq(rng, 256)
        got = []
        for rf in pair("runtime.rf"):
            rx = rf.NetRfDevice("rx_port=0")
            port = rx._src.sock.getsockname()[1]
            tx = rf.NetRfDevice(f"tx_addr=127.0.0.1,tx_port={port}")
            tx.send_timed(burst, None)
            got.append(rx.recv_with_time(256))
            rx.close()
            tx.close()
        for samples, ts in got:
            assert ts == 0
            np.testing.assert_array_equal(samples, burst)


class TestStreamRfDevice:
    def test_file_stream_equals_the_jax_file_device(self, tmp_path, rng):
        """The port's ``StreamRfDevice`` (native ring, file producer) reads
        a capture as the JAX package's ``FileRfDevice`` does: the same
        samples and timestamps, read by read."""
        jax_rf, port_rf = pair("runtime.rf")
        p = tmp_path / "iq.bin"
        iq(rng, 5000).tofile(p)
        ref = jax_rf.rf_open("file", f"rx={p}")
        dev = port_rf.rf_open("stream", f"rx={p}")
        for n in (1000, 1920, 2080):
            (a, ta), (b, tb) = ref.recv_with_time(n), dev.recv_with_time(n)
            assert ta == tb
            np.testing.assert_array_equal(a, b)
        dev.close()
        ref.close()


class TestRadio:
    def test_earfcn_tuning_and_tx_advance(self, tmp_path):
        out = []
        for k, rf in enumerate(pair("runtime.rf")):
            p = str(tmp_path / f"iq{k}.bin")
            radio = rf.Radio(rf.FileRfDevice(f"tx={p}"),
                             tx_advance_samples=10)
            radio.set_tx_srate(1.92e6)
            radio.dev.set_rx_freq(0)
            radio.set_tx_freq_earfcn(3400)   # band 7: UL 2.565 GHz
            radio.set_rx_freq_earfcn(3400)   # DL 2.685 GHz
            radio.tx(np.ones(50, np.complex64), timestamp=100)
            sob = [radio.is_start_of_burst]
            radio.tx_end()
            sob.append(radio.is_start_of_burst)
            radio.close()
            out.append((radio.dev.tx_freq, radio.dev.rx_freq, sob,
                        pathlib.Path(p).read_bytes()))
        assert out[0] == out[1]
        tx_freq, rx_freq, sob, raw = out[1]
        assert abs(tx_freq - 2.565e9) < 1e6 and abs(rx_freq - 2.685e9) < 1e6
        assert sob == [False, True]
        got = np.frombuffer(raw, np.complex64)
        # the tx advance pulled the burst 10 samples early
        assert len(got) == 140 and np.all(got[:90] == 0)
        assert np.all(got[90:] == 1)


# --- the native ring buffer (tests/test_native_stream.py) --------------------


@pytest.fixture
def stream_mod():
    from empower_srslte_tpu_torch.runtime import stream
    from empower_srslte_tpu_torch.utils import cuda_build

    lib = stream.load_native()
    assert lib is not None, "g++ could not build csrc/ring_buffer.cpp"
    assert pathlib.Path(lib._name) == cuda_build.library_path("ring_buffer")
    return stream


class TestNativeStream:
    def test_push_read_roundtrip(self, stream_mod, rng):
        data = iq(rng, 20000)
        with stream_mod.SampleStream(1 << 15) as s:
            assert s.push(data) == 20000
            out, ts = s.read(20000)
            assert ts == 0 and s.overflows == 0
            np.testing.assert_array_equal(out, data)

    def test_timestamps_monotonic(self, stream_mod, rng):
        with stream_mod.SampleStream(1 << 14) as s:
            s.push(iq(rng, 4096))
            assert s.available == 4096
            _, t0 = s.read(1000)
            _, t1 = s.read(1000)
            assert (t0, t1) == (0, 1000) and s.available == 2096

    def test_overflow_counted(self, stream_mod):
        small = stream_mod.SampleStream(1 << 10)         # 1024 samples
        assert small.push(np.ones(5000, np.complex64)) == 1024
        assert small.overflows == 5000 - 1024
        small.close()

    def test_short_read_is_zero_padded(self, stream_mod, rng):
        data = iq(rng, 100)
        with stream_mod.SampleStream(1 << 10) as s:
            s.push(data)
            out, _ = s.read(150, timeout_ms=20)
        np.testing.assert_array_equal(out[:100], data)
        assert np.all(out[100:] == 0)

    def test_file_producer(self, stream_mod, tmp_path, rng):
        data = iq(rng, 30000)
        p = tmp_path / "iq.bin"
        data.tofile(p)
        with stream_mod.SampleStream(1 << 16) as s:
            s.start_file(str(p))
            out, _ = s.read(30000, timeout_ms=3000)
            np.testing.assert_array_equal(out, data)
            with pytest.raises(IOError):
                s.start_file(str(tmp_path / "missing.bin"))

    def test_udp_producer(self, stream_mod, rng):
        from empower_srslte_tpu_torch.runtime.io import NetSink

        data = iq(rng, 8192)
        with stream_mod.SampleStream(1 << 15) as s:
            port = s.start_udp("127.0.0.1", 0)
            sink = NetSink("127.0.0.1", port)
            sink.write(data)
            time.sleep(0.3)
            out, _ = s.read(8192, timeout_ms=2000)
            np.testing.assert_array_equal(out, data)
            sink.close()

    def test_failed_build_raises_without_fallback(self, monkeypatch,
                                                  tmp_path):
        """A ring buffer that does not compile makes ``SampleStream()``
        raise; ``load_native()`` says None, as the JAX package's does."""
        from empower_srslte_tpu_torch.runtime import stream
        from empower_srslte_tpu_torch.utils import cuda_build

        (tmp_path / "ring_buffer.cpp").write_text("not C++\n")
        monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
        monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
        monkeypatch.setattr(cuda_build, "_LIBS", {})
        monkeypatch.setattr(stream, "_lib", None)
        with pytest.raises(RuntimeError, match="native runtime") as e:
            stream.SampleStream()
        assert "ring_buffer.cpp" in str(e.value.__cause__)
        assert stream.load_native() is None
        assert not list((tmp_path / "_build").glob("*.so"))


# --- sample I/O, config, metrics (test_mac_runtime.py TestRuntime) -----------


class TestSampleIo:
    def test_file_io_roundtrip(self, tmp_path, rng):
        data = iq(rng, 1000)
        raw, reads = [], []
        for k, rio in enumerate(pair("runtime.io")):
            p = str(tmp_path / f"iq{k}.bin")
            with rio.FileSink(p) as sink:
                sink.write(data[:600])
                sink.write(data[600:])
            raw.append(pathlib.Path(p).read_bytes())
            src = rio.FileSource(p)
            first = src.read(700)
            reads.append((first, src.remaining(), src.read(300),
                           src.read(10), src.read_all()))
        assert raw[0] == raw[1] == data.tobytes()
        for a, b in zip(*reads):
            np.testing.assert_array_equal(a, b)
        # zero-padded past EOF like the reference's filesource
        assert np.all(reads[1][3] == 0)

    @pytest.mark.parametrize("transport", ["udp", "tcp"])
    @pytest.mark.parametrize("sender,receiver", [("torch", "torch"),
                                                 ("torch", "jax"),
                                                 ("jax", "torch")])
    def test_net_io_roundtrip(self, rng, transport, sender, receiver):
        """netsource.c / netsink.c over UDP datagrams or one TCP sender;
        each package's sink talks to either package's source."""
        mods = dict(zip(("jax", "torch"), pair("runtime.io")))
        data = iq(rng, 4096)
        src = mods[receiver].NetSource(port=0, timeout=2.0,
                                       transport=transport)
        port = src.sock.getsockname()[1]
        sink = mods[sender].NetSink("127.0.0.1", port, transport=transport)
        sink.write(data)
        out = src.read(4096)
        src.close()
        sink.close()
        np.testing.assert_array_equal(out, data)

    def test_config_ini_and_overrides(self, tmp_path):
        ini = tmp_path / "enb.conf"
        ini.write_text("[cell]\nnof_prb = 100\ncell_id = 3\n[log]\n"
                       "phy_level = debug\n[rf]\nfreq_hz = 2.1e9\n"
                       "device = net\n")
        overrides = ["--expert.turbo_iterations=7", "cell.nof_ports=2"]
        cfgs = [c.load_config(str(ini), overrides=overrides)
                for c in pair("runtime.config")]
        assert dataclasses.asdict(cfgs[0]) == dataclasses.asdict(cfgs[1])
        cfg = cfgs[1]
        assert cfg.cell.nof_prb == 100 and cfg.cell.cell_id == 3
        assert cfg.cell.nof_ports == 2 and cfg.log.phy_level == "debug"
        assert cfg.expert.turbo_iterations == 7
        assert cfg.rf.freq_hz == 2.1e9 and cfg.rf.device == "net"
        for c in pair("runtime.config"):
            with pytest.raises(KeyError, match="unknown option"):
                c.load_config(None, overrides=["cell.no_such_key=1"])

    def test_metrics_hub(self, tmp_path):
        texts, rows = [], []
        for k, m in enumerate(pair("runtime.metrics")):
            hub = m.MetricsHub()
            buf = io.StringIO()
            csv_path = tmp_path / f"m{k}.csv"
            hub.add_listener(m.MetricsStdout(file=buf, header_every=2))
            csvl = m.MetricsCsv(str(csv_path))
            hub.add_listener(csvl)
            for i, (mbps, bler) in enumerate(((42.5, 0.01), (43.0, 0.02),
                                              (41.0, 0.0))):
                hub.report({"sf": 10 * (i + 1), "dl_mbps": mbps,
                            "bler": bler})
            csvl.close()
            texts.append(buf.getvalue())
            lines = csv_path.read_text().strip().splitlines()
            # drop the wall-clock stamp ("t", the first column)
            rows.append([ln.split(",", 1)[1] for ln in lines])
        assert texts[0] == texts[1]
        assert "dl_mbps" in texts[1] and "42.500" in texts[1]
        assert rows[0] == rows[1] and len(rows[1]) == 4   # header + 3


# --- crash handler and pcap (TestPcapCrash, TestPcapWriters) -----------------


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both packages' pcap modules stamp records with one fixed time."""
    mods = pair("runtime.pcap")
    clock = types.SimpleNamespace(time=lambda: 1_700_000_000.25)
    for m in mods:
        monkeypatch.setattr(m, "time", clock)
    return mods


class TestPcap:
    def test_mac_pcap(self, tmp_path, fixed_clock):
        import struct

        raw = []
        for k, pcap in enumerate(fixed_clock):
            p = tmp_path / f"mac{k}.pcap"
            with pcap.MacPcap(str(p)) as pc:
                pc.write_pdu(b"\x3f\x21\x00\x01", rnti=0x1234, tti=123)
                pc.write_pdu(b"\x1f\x00", rnti=0x46, tti=10239,
                             direction=pcap.RADIO_UL)
            raw.append(p.read_bytes())
        assert raw[0] == raw[1]
        magic, *_, dlt = struct.unpack("<IHHiIII", raw[1][:24])
        assert magic == 0xA1B2C3D4 and dlt == fixed_clock[1].DLT_USER0
        assert b"mac-lte" in raw[1] and b"\x3f\x21\x00\x01" in raw[1]

    @pytest.mark.parametrize("cls", ["NasPcap", "S1apPcap"])
    def test_nas_s1ap_raw(self, tmp_path, fixed_clock, cls):
        import struct

        raw = []
        for k, pcap in enumerate(fixed_clock):
            p = tmp_path / f"raw{k}.pcap"
            with getattr(pcap, cls)(str(p)) as pc:
                pc.write_pdu(b"\x07\x41\x01")
            raw.append(p.read_bytes())
        assert raw[0] == raw[1]
        hdr = struct.unpack("<IHHiIII", raw[1][:24])
        assert hdr[6] == {"NasPcap": 148, "S1apPcap": 150}[cls]
        assert raw[1][40:43] == b"\x07\x41\x01"

    @pytest.mark.parametrize("mode", ["RLC_AM_MODE", "RLC_UM_MODE",
                                      "RLC_TM_MODE"])
    def test_rlc_context_framing(self, tmp_path, fixed_clock, mode):
        raw = []
        for k, pcap in enumerate(fixed_clock):
            p = tmp_path / f"rlc{k}.pcap"
            with pcap.RlcPcap(str(p), ue_id=17) as pc:
                pc.write_rlc_pdu(b"\x88\x00payload", mode=getattr(pcap, mode),
                                 channel_id=1, sn_length=5)
            raw.append(p.read_bytes())
        assert raw[0] == raw[1]
        assert raw[1][20:24] == (149).to_bytes(4, "little")
        body = raw[1][40:]
        assert b"rlc-lte" in body and body.endswith(b"payload")


@pytest.mark.parametrize("pkg", [JAX_PKG, PORT_PKG])
def test_crash_handler_writes(tmp_path, pkg):
    """An uncaught exception's traceback lands in the crash file, the
    same last line from either package."""
    crash = tmp_path / "bt.crash"
    code = (f"from {pkg}.runtime import crash;"
            f"crash.install({str(crash)!r});"
            "raise RuntimeError('boom')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       cwd=str(ROOT), timeout=120)
    assert r.returncode != 0
    text = crash.read_text()
    assert text.startswith("--- crash at ")
    assert text.strip().splitlines()[-1] == "RuntimeError: boom"


# --- band tables (TestBandTables) --------------------------------------------


def _band_row(band, earfcn: int):
    out = []
    for fn in (band.band_from_dl_earfcn, band.dl_freq_hz,
               band.ul_earfcn_from_dl, band.ul_freq_hz):
        try:
            out.append(fn(earfcn))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


def test_band_tables_equal_over_every_earfcn():
    """Every EARFCN of every band in the table, as a DL and as a UL
    EARFCN: band, DL frequency, paired UL EARFCN and UL frequency (or the
    same refusal) are equal."""
    jband, band = pair("utils.band")
    assert jband._BANDS == band._BANDS
    last = band._BANDS[-1]
    top = max(last[2], max(b[3] for b in band._BANDS)) + 1000
    for earfcn in range(top):
        assert _band_row(jband, earfcn) == _band_row(band, earfcn), earfcn
    assert band.dl_freq_hz(1575) == 1842.5e6
    assert band.ul_earfcn_from_dl(1575) == 19575
    assert band.ul_freq_hz(19575) == 1747.5e6
    assert abs(band.ul_freq_hz(band.ul_earfcn_from_dl(6300)) - 847e6) < 1
    assert band.band_from_dl_earfcn(66500) == 66
    with pytest.raises(ValueError):
        band.ul_earfcn_from_dl(9700)                    # band 29, SDL


# --- libconf -----------------------------------------------------------------


RR_CONF = """
mac_cnfg = {
  phr_cnfg = { dl_pathloss_change = "3dB"; periodic_phr_timer = 50;
               prohibit_phr_timer = 0; };
  ulsch_cnfg = { max_harq_tx = 4; periodic_bsr_timer = 20;
                 retx_bsr_timer = 320; };
  time_alignment_timer = -1;
};
phy_cnfg = {
  sched_request_cnfg = { dsr_trans_max = 64; period = 20; subframe = [1];
                         nof_prb = 2; };
};
"""
DRB_CONF = """
qci_config = (
  { qci = 7;
    pdcp_config = { discard_timer = 100; pdcp_sn_size = 12; };
    rlc_config = { ul_um = { sn_field_length = 10; };
                   dl_um = { sn_field_length = 10; t_reordering = 45; }; };
    logical_channel_config = { priority = 13; prioritized_bit_rate = -1;
                               bucket_size_duration = 100;
                               log_chan_group = 1; }; },
  { qci = 9;
    pdcp_config = { discard_timer = 150; status_report_required = true; };
    rlc_config = { ul_am = { t_poll_retx = 120; poll_pdu = 64; };
                   dl_am = { t_reordering = 45; t_status_prohibit = 0; }; };
    logical_channel_config = { priority = 11; prioritized_bit_rate = -1;
                               bucket_size_duration = 100;
                               log_chan_group = 3; }; }
);
"""
SIB_CONF = """
sib1 = { intra_freq_reselection = "Allowed"; q_rx_lev_min = -65;
         cell_barred = "NotBarred"; si_window_length = 20;
         sched_info = ( { si_periodicity = 16; si_mapping_info = [ 3 ]; } );
         system_info_value_tag = 0; };
sib2 = { rr_config_common_sib = {
           rach_cnfg = { num_ra_preambles = 52; preamble_trans_max = 10;
                         ra_resp_win_size = 10; mac_con_res_timer = 64;
                         max_harq_msg3_tx = 4; };
           prach_cnfg = { root_sequence_index = 128;
             prach_cnfg_info = { high_speed_flag = false;
                                 prach_config_index = 3;
                                 prach_freq_offset = 2;
                                 zero_correlation_zone_config = 5; }; }; }; };
sib3 = { cell_reselection_common = { q_hyst = 2; }; };
"""
GRAMMAR = [
    'a = 1; b = -2.5; c = true; d = "hi"; e = 0x1F; f = 12L;',
    "top = { sub = { x = 1; }; lst = ( { y = 2; }, { y = 3; } ); "
    "arr = [1, 2, 3]; };",
    "// line\n# hash\n/* block\n comment */\na = \"no semicolon\"\nb = 2;",
    "a : 5; m = []; ",
]


class TestLibconf:
    @pytest.mark.parametrize("text", GRAMMAR)
    def test_grammar(self, text):
        jl, lc = pair("runtime.libconf")
        assert lc.parse(text) == jl.parse(text)

    def test_bad_token_raises_alike(self):
        msgs = []
        for lc in pair("runtime.libconf"):
            with pytest.raises(ValueError) as e:
                lc.parse("a = @@;")
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    def test_mappers(self, tmp_path):
        jl, lc = pair("runtime.libconf")
        for name, text in (("rr", RR_CONF), ("drb", DRB_CONF),
                           ("sib", SIB_CONF)):
            (tmp_path / f"{name}.conf").write_text(text)
        trees = [(m.parse_file(str(tmp_path / "rr.conf")),
                  m.parse_file(str(tmp_path / "drb.conf")),
                  m.parse_file(str(tmp_path / "sib.conf")))
                 for m in (jl, lc)]
        assert trees[0] == trees[1]
        rr, drb, sib = trees[1]
        mac_j, mac = jl.load_mac_cnfg(rr), lc.load_mac_cnfg(rr)
        assert type(mac).__module__.startswith(PORT_PKG)
        assert dataclasses.asdict(mac_j) == dataclasses.asdict(mac)
        assert mac.periodic_bsr_timer_ms == 20 and mac.dsr_trans_max == 64
        drb_j, drb_p = jl.load_drb_conf(drb), lc.load_drb_conf(drb)
        assert {k: dataclasses.asdict(v) for k, v in drb_j.items()} == \
            {k: dataclasses.asdict(v) for k, v in drb_p.items()}
        assert drb_p[9].rlc_mode == "am" and drb_p[7].rlc_mode == "um"
        assert jl.load_sib_conf(sib) == lc.load_sib_conf(sib)


# --- trace -------------------------------------------------------------------


class TestTrace:
    def test_signal_dump_round_trip(self, tmp_path, rng):
        jtrace, trace = pair("runtime.trace")
        grid = iq(rng, 2 * 72).reshape(2, 72)
        bits = rng.integers(0, 2, size=616).astype(np.int8)
        paths = []
        for k, (m, g) in enumerate(((jtrace, grid),
                                    (trace, torch.as_tensor(grid)))):
            dump = m.SignalDump()
            dump.add("grid", g)
            dump.add("bits", bits)
            assert len(dump) == 2
            paths.append(str(tmp_path / f"dump{k}.npz"))
            dump.save(paths[-1])
        ref, got = jtrace.load_dump(paths[0]), trace.load_dump(paths[1])
        assert sorted(got) == sorted(ref) == ["bits", "grid"]
        for name in ref:
            assert got[name].dtype == ref[name].dtype
            np.testing.assert_array_equal(got[name], ref[name])

    def test_profiler_trace_writes_a_chrome_trace(self, tmp_path):
        from empower_srslte_tpu_torch.runtime.trace import profiler_trace

        x = torch.ones(256, dtype=torch.complex64)
        with profiler_trace(str(tmp_path / "prof")):
            torch.fft.ifft(torch.fft.fft(x))
        events = json.loads((tmp_path / "prof" / "trace.json").read_text())
        names = {e.get("name") for e in events["traceEvents"]}
        assert "aten::fft_fft" in names or any(
            "fft" in str(n) for n in names)
