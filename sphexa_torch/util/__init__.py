"""Host-side utilities of the port (sphexa_tpu/util): the phase taxonomy
and the debug checks (``phases``), the loop's lap timer and profile
series (``timer``), the split execution that times a step's stages
(``substep_profile``)."""
