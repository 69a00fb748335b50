"""Example serve applications for config-file deploys and tests
(reference: serve/tests/test_config_files/*)."""

from __future__ import annotations

from .deployment import deployment


@deployment
class Echo:
    """Returns its input unchanged."""

    async def __call__(self, request):
        return request


echo_app = Echo.bind()


def adder_app(increment: int = 1):
    """Builder-function style application (``import_path`` with args)."""

    @deployment(name="Adder")
    class Adder:
        def __init__(self, inc: int):
            self.inc = inc

        async def __call__(self, request):
            return request + self.inc

    return Adder.bind(increment)
