"""Launchers of the port: the cohort mesh (``launch.mesh``).

Port of ``repro.launch`` as far as the engine uses it; the production and
multi-host meshes, the servers and the dry runs are not ported.
"""
