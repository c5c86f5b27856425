"""Work counts (operations and bytes) of the program's regions, from the
configuration's shapes and the CRF's parameters, never from the kernels
that implement them; and the card's peaks they are held against."""
