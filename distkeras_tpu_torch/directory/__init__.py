"""Membership directory and routing: one cluster across hosts.

Port of ``distkeras_tpu/directory/``. A small replicated coordination
service mapping ``(role, key)``, e.g. ``("ps", "shard-01")``, ``("serve",
replica)`` or ``("shm", segment)``, to ``(endpoint, fence epoch, lease)``:

- :class:`DirectoryServer` / :class:`StandbyDirectoryServer`: the
  WAL-backed, chain-replicated service (``service.py``);
- :class:`DirectoryClient` / :class:`DirectoryEndpoint` /
  :func:`build_ps_client`: discovery. A joiner builds its whole sharded
  PS client from a lookup, and a failover re-resolves through the
  directory (``client.py``);
- :class:`RoutedGenerationClient`: the prefix-hash, cache-affine serving
  router with health-gated failover (``router.py``);
- :class:`HostedDirectory`: the trainer-side hosting and registration
  behind the ``directory=`` knob (``host.py``).

All of it is host code (sockets, a WAL-backed map, leases); no kernel
runs here.
"""

from distkeras_tpu_torch.directory.client import (
    DirectoryClient,
    DirectoryEndpoint,
    build_ps_client,
    install_shm_rendezvous,
    parse_seeds,
)
from distkeras_tpu_torch.directory.host import HostedDirectory
from distkeras_tpu_torch.directory.router import (
    RoutedGenerationClient,
    prefix_route_key,
)
from distkeras_tpu_torch.directory.service import (
    DirectoryServer,
    DirectoryState,
    StandbyDirectoryServer,
    apply_directory_record,
    directory_state_dict,
    recover_directory_state,
)

__all__ = [
    "DirectoryServer", "StandbyDirectoryServer", "DirectoryState",
    "apply_directory_record", "directory_state_dict",
    "recover_directory_state",
    "DirectoryClient", "DirectoryEndpoint", "build_ps_client",
    "install_shm_rendezvous", "parse_seeds",
    "RoutedGenerationClient", "prefix_route_key",
    "HostedDirectory",
]
