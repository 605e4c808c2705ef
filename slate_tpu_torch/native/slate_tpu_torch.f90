! Generated by slate_tpu_torch/compat/fortran.py; do not edit.
! Fortran interfaces to the slate_tpu_torch driver C API
! (slate_tpu_torch/native/slate_tpu_torch_capi.h).  Buffers are
! ROW-major with row stride ld*: pass transposed data or
! row-major arrays.
module slate_tpu_torch
  use iso_c_binding
  implicit none
  interface

    integer(c_int) function slate_tpu_torch_init() &
        bind(c, name='slate_tpu_torch_init')
      use iso_c_binding
    end function slate_tpu_torch_init

    subroutine slate_tpu_torch_finalize() &
        bind(c, name='slate_tpu_torch_finalize')
    end subroutine slate_tpu_torch_finalize

    ! Solve A X = B by partially-pivoted LU.
    integer(c_int) function slate_tpu_torch_dgesv( &
        n, nrhs, a, lda, b, ldb, x, ldx, nb) &
        bind(c, name='slate_tpu_torch_dgesv')
      use iso_c_binding
      integer(c_int64_t), value, intent(in) :: n
      integer(c_int64_t), value, intent(in) :: nrhs
      real(c_double), dimension(*), intent(in) :: a
      integer(c_int64_t), value, intent(in) :: lda
      real(c_double), dimension(*), intent(in) :: b
      integer(c_int64_t), value, intent(in) :: ldb
      real(c_double), dimension(*), intent(inout) :: x
      integer(c_int64_t), value, intent(in) :: ldx
      integer(c_int64_t), value, intent(in) :: nb
    end function slate_tpu_torch_dgesv

    ! Solve A X = B, A Hermitian positive definite.
    integer(c_int) function slate_tpu_torch_dposv( &
        n, nrhs, a, lda, b, ldb, x, ldx, nb) &
        bind(c, name='slate_tpu_torch_dposv')
      use iso_c_binding
      integer(c_int64_t), value, intent(in) :: n
      integer(c_int64_t), value, intent(in) :: nrhs
      real(c_double), dimension(*), intent(in) :: a
      integer(c_int64_t), value, intent(in) :: lda
      real(c_double), dimension(*), intent(in) :: b
      integer(c_int64_t), value, intent(in) :: ldb
      real(c_double), dimension(*), intent(inout) :: x
      integer(c_int64_t), value, intent(in) :: ldx
      integer(c_int64_t), value, intent(in) :: nb
    end function slate_tpu_torch_dposv

    ! Least squares min ||A X - B||.
    integer(c_int) function slate_tpu_torch_dgels( &
        m, n, nrhs, a, lda, b, ldb, x, ldx, nb) &
        bind(c, name='slate_tpu_torch_dgels')
      use iso_c_binding
      integer(c_int64_t), value, intent(in) :: m
      integer(c_int64_t), value, intent(in) :: n
      integer(c_int64_t), value, intent(in) :: nrhs
      real(c_double), dimension(*), intent(in) :: a
      integer(c_int64_t), value, intent(in) :: lda
      real(c_double), dimension(*), intent(in) :: b
      integer(c_int64_t), value, intent(in) :: ldb
      real(c_double), dimension(*), intent(inout) :: x
      integer(c_int64_t), value, intent(in) :: ldx
      integer(c_int64_t), value, intent(in) :: nb
    end function slate_tpu_torch_dgels

    ! Eigenvalues (ascending) of symmetric A.
    integer(c_int) function slate_tpu_torch_dsyev( &
        n, a, lda, w, nb) &
        bind(c, name='slate_tpu_torch_dsyev')
      use iso_c_binding
      integer(c_int64_t), value, intent(in) :: n
      real(c_double), dimension(*), intent(in) :: a
      integer(c_int64_t), value, intent(in) :: lda
      real(c_double), dimension(*), intent(inout) :: w
      integer(c_int64_t), value, intent(in) :: nb
    end function slate_tpu_torch_dsyev

    ! Singular values (descending) of A.
    integer(c_int) function slate_tpu_torch_dgesvd( &
        m, n, a, lda, s, nb) &
        bind(c, name='slate_tpu_torch_dgesvd')
      use iso_c_binding
      integer(c_int64_t), value, intent(in) :: m
      integer(c_int64_t), value, intent(in) :: n
      real(c_double), dimension(*), intent(in) :: a
      integer(c_int64_t), value, intent(in) :: lda
      real(c_double), dimension(*), intent(inout) :: s
      integer(c_int64_t), value, intent(in) :: nb
    end function slate_tpu_torch_dgesvd

  end interface
end module slate_tpu_torch
