"""``pio deploy --access-log`` and ``pio eventserver --access-log`` on the
port, held against the JAX package.

The JAX package's ``pio deploy`` and ``pio eventserver`` take
``--access-log`` / ``--no-access-log`` (``ServerConfig.access_log`` and
``EventServerConfig.access_log``; None defers to ``PIO_ACCESS_LOG``). The
port had neither the flags nor the config fields, so the documented
command line ``pio deploy --batching --tracing --access-log`` exited 2
on the port and a server could only be switched by the environment.
Each case here builds both packages' parsers or servers on the same
input and compares what they decide.
"""

from __future__ import annotations

import dataclasses

import pytest

from predictionio_tpu.api import event_server as jes
from predictionio_tpu.cli import pio as jpio
from predictionio_tpu.workflow import deploy as jdeploy
from predictionio_tpu_torch.api import event_server as pes
from predictionio_tpu_torch.cli import pio as ppio
from predictionio_tpu_torch.workflow import deploy as pdeploy
from test_torch_event_server import _jax_service, _port_service


def _parser(module, late_bound: str):
    __import__(late_bound)
    parser = module.build_parser()
    for _name, configure in module._EXTRA_PARSERS:
        configure(parser.subparsers)
    return parser


@pytest.mark.parametrize("command", ["deploy", "eventserver"])
@pytest.mark.parametrize("flag", [["--access-log"], ["--no-access-log"], []])
def test_the_flag_parses_as_in_jax(command, flag):
    jax = _parser(jpio, "predictionio_tpu.workflow.cli_commands")
    port = _parser(ppio, "predictionio_tpu_torch.experiment.cli")
    argv = [command, "--port", "0", *flag]
    assert port.parse_args(argv).access_log == jax.parse_args(argv).access_log


@pytest.mark.parametrize("config", [(jdeploy.ServerConfig, pdeploy.ServerConfig),
                                    (jes.EventServerConfig, pes.EventServerConfig)],
                         ids=["ServerConfig", "EventServerConfig"])
def test_the_config_field_is_the_jax_package_s(config):
    jax_cls, port_cls = config
    fields = {f.name: f.default for f in dataclasses.fields(jax_cls)}
    port_fields = {f.name: f.default for f in dataclasses.fields(port_cls)}
    assert port_fields["access_log"] == fields["access_log"] is None


@pytest.mark.parametrize("override", [True, False, None])
@pytest.mark.parametrize("env", ["1", None])
def test_the_event_server_decides_as_in_jax(override, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("PIO_ACCESS_LOG", raising=False)
    else:
        monkeypatch.setenv("PIO_ACCESS_LOG", env)
    jax = _jax_service(access_log=override)
    port = _port_service(access_log=override)
    assert port.access_log == jax.access_log == (override if override is not None
                                                 else env == "1")
