"""Store layer of the port; so far only the I/O error taxonomy
(``reliability``) that the progressive reader's degrade policy catches."""
